"""Datasets: the padded row blocks every estimator trains on."""
