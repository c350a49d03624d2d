"""The paper's substrate on torch tensors: packing, quantizers, product
LUTs, packed serving weights and quantized execution plans."""
