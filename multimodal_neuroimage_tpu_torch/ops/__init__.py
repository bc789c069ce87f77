"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper takes its plain PyTorch version for a CPU tensor and launches
its CUDA kernel (or raises) for a CUDA tensor, and counts its launches in a
``launches`` attribute, which :func:`reset_launches` and :func:`launches`
clear and read across all kernels.
"""

from __future__ import annotations

from typing import Dict


def kernels() -> Dict[str, object]:
    """{kernel name: wrapper} for every kernel of the port."""
    from multimodal_neuroimage_tpu_torch.ops.attention import (
        fused_window_attention)
    from multimodal_neuroimage_tpu_torch.ops.bert_layer import bert_layer_call
    from multimodal_neuroimage_tpu_torch.ops.fusion_block import (
        fused_cross_fusion_block, fused_fusion_block)
    return {"K1 bert_layer": bert_layer_call,
            "K2 fusion_block": fused_fusion_block,
            "K3 cross_fusion_block": fused_cross_fusion_block,
            "K4 window_attention": fused_window_attention}


def reset_launches() -> None:
    for fn in kernels().values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in kernels().items()}
