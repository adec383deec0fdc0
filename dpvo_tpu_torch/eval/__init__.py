"""Evaluation of the port (numpy): ``ate`` (alignment, ATE-RMSE, timestamp
association), ``export`` (TUM trajectories, PLY, COLMAP, plots) and
``protocol`` (the N-trial scoring of a dataset)."""
