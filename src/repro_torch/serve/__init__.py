"""In-process serving of a posterior summary."""
