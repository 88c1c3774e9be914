"""The LM substrate: config, parameters, layers, GQA attention, the layer
stack and the decoder-only language model (prefill forward and cached
decode)."""
