"""Causal GQA flash attention: the CUDA kernel, its plain version and the
public wrapper."""
