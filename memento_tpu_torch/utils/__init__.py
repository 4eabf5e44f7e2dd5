"""Phase timers and progress reporting."""
