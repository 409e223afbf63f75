"""Sampler core: containers, random numbers, hyper-parameters, posterior updates, the sweep."""
