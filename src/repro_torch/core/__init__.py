"""Q8_0 quantization, quantization policy and quantized linear layers."""
