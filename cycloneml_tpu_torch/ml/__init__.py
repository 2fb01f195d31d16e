"""The MLlib-style estimator API."""
