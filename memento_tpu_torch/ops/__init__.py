"""Device and host numerics: estimators, compression, sampling, kernels."""
