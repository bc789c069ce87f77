"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper takes its plain PyTorch version for a CPU tensor and launches
its CUDA kernel (or raises) for a CUDA tensor, and counts its launches in a
``launches`` attribute, which :func:`reset_launches` and :func:`launches`
clear and read across all kernels. The forward wrappers are autograd
Functions whose backward is the matching backward wrapper.
"""

from __future__ import annotations

from typing import Dict


def kernels() -> Dict[str, object]:
    """{kernel name: wrapper} for every kernel of the port."""
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    from multimodal_neuroimage_tpu_torch.ops import fused_update as fu
    return {"K1 bert_layer": bl.bert_layer_call,
            "K2 fusion_block": fb.fused_fusion_block,
            "K3 cross_fusion_block": fb.fused_cross_fusion_block,
            "K4 window_attention": att.fused_window_attention,
            "K1 bert_layer backward": bl.bert_layer_backward,
            "K2 fusion_block backward": fb.fused_fusion_block_backward,
            "K3 cross_fusion_block backward":
                fb.fused_cross_fusion_block_backward,
            "K4 window_attention backward": att.window_attention_backward,
            "K5 fused_adam": fu.fused_adam_update}


def reset_launches() -> None:
    for fn in kernels().values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in kernels().items()}
