"""Operations: masks, INT8 quantization, linear layers, attention."""
