"""Quantized CNNs: the PULP-NN layer set, the graph interpreter, configs."""
