"""LoRAQuant core on PyTorch: quantizers, SVD split, STE refine, pipeline,
the ablation variants and the Table-1 baselines."""

from .quant import (
    GROUP_SIZE_DEFAULT,
    QuantizedTensor,
    binary_dequantize,
    binary_fake_quant,
    binary_quantize,
    pack_codes,
    rtn_dequantize,
    rtn_fake_quant,
    rtn_quantize,
    storage_bits,
    unpack_codes,
)
from .svd_split import (
    SVDReparam,
    select_h,
    split_at,
    svd_reparam,
    svd_reparam_stack,
)
from .ste import als_refine_pairs, optimize_pairs
from .loraquant import (
    LoRAQuantConfig,
    QuantRecipe,
    QuantizedLoRA,
    adapter_avg_bits,
    dequantize_lora,
    fit_recipe,
    quantize_adapter_set,
    quantize_lora,
    quantize_lora_pairs,
    quantize_lora_stack,
    quantize_lora_stacks,
)
from .ablations import quantize_lora_variant
from . import baselines

__all__ = [
    "GROUP_SIZE_DEFAULT",
    "QuantizedTensor",
    "binary_dequantize",
    "binary_fake_quant",
    "binary_quantize",
    "pack_codes",
    "rtn_dequantize",
    "rtn_fake_quant",
    "rtn_quantize",
    "storage_bits",
    "unpack_codes",
    "SVDReparam",
    "select_h",
    "split_at",
    "svd_reparam",
    "svd_reparam_stack",
    "als_refine_pairs",
    "optimize_pairs",
    "LoRAQuantConfig",
    "QuantRecipe",
    "QuantizedLoRA",
    "adapter_avg_bits",
    "dequantize_lora",
    "fit_recipe",
    "quantize_adapter_set",
    "quantize_lora",
    "quantize_lora_pairs",
    "quantize_lora_stack",
    "quantize_lora_stacks",
    "quantize_lora_variant",
    "baselines",
]
