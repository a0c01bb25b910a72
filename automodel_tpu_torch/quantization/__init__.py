"""Weight quantization for fine-tuning (counterpart of ``automodel_tpu/quantization/``):
QLoRA's int8 / nf4 base and QAT's fake quantization."""

from automodel_tpu_torch.quantization.qat import QATConfig, fake_quant, fake_quant_params
from automodel_tpu_torch.quantization.qlora import (dequantize_leaf, dequantize_params,
                                                    is_quantized_leaf, quantize_leaf,
                                                    quantize_params, tree_nbytes)

__all__ = ["QATConfig", "dequantize_leaf", "dequantize_params", "fake_quant",
           "fake_quant_params", "is_quantized_leaf", "quantize_leaf", "quantize_params",
           "tree_nbytes"]
