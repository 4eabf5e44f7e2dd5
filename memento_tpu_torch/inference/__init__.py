"""Hypothesis tests: meta-regression, ASL, GEV refinement, tiled tests."""
