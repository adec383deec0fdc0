"""Trajectory evaluation of the port (numpy): ``ate`` (Umeyama alignment,
ATE-RMSE)."""
