"""Geometric estimators: batched RANSAC solvers (counterpart of
``hyslam_tpu/estimators``: the two-view H/F estimator and PnP; the Sim3
solver is ROADMAP step 15b)."""
