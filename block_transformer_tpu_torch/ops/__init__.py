"""Operations: masks, INT8 / INT4 quantization, linear layers, attention."""
