"""Request kinds: one module per ``kind`` that a traffic file names."""
