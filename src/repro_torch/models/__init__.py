"""The LM scaffold's models: configs, parameter descriptors, layers, attention, the stack and ``LMModel``."""
