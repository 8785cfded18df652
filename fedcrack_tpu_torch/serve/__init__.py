"""The quantized serving path: engine, batcher, quant gate, version manager."""
