"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked ``cuda`` and skips without a card. On a machine
with one (which has no jax, so skip tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Shapes are small and deliberately ragged (odd head dim 7, keys masked past
t_valid, partial row tiles, N = 9 windows). Both sides run float32 on the
card with TF32 off; |kernel - plain| <= 1e-4 + 2e-4 * |plain|, the same
bound chip_smoke.py holds the kernels to at the flagship's shapes.
"""

import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu_torch.nn.common import full_f32
from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
from multimodal_neuroimage_tpu_torch.ops import attention as att
from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb

pytestmark = pytest.mark.cuda
ATOL, RTOL = 1e-4, 2e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with full_f32():
        yield torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _rand(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def _lin(gen, o, i):
    return [_rand(gen, o, i, scale=i ** -0.5), _rand(gen, o, scale=0.1)]


def _ln(gen, c):
    return [1 + _rand(gen, c, scale=0.1), _rand(gen, c, scale=0.1)]


@pytest.mark.parametrize("B,T,H,heads,F,t_valid", [
    (2, 37, 28, 4, 64, 37), (3, 45, 28, 4, 96, 30), (1, 369, 84, 12, 3072, 369)])
def test_bert_layer_kernel(dev, B, T, H, heads, F, t_valid):
    gen = torch.Generator().manual_seed(T + H)
    p = tuple(t.to(dev) for t in sum((_lin(gen, H, H) for _ in range(4)), [])
              + _ln(gen, H) + _lin(gen, F, H) + _lin(gen, H, F) + _ln(gen, H))
    x = _rand(gen, B, T, H).to(dev)
    before = bl.bert_layer_call.launches
    got = bl.bert_layer_call(x, p, heads, t_valid)
    assert bl.bert_layer_call.launches == before + 1
    _close(got, bl.bert_layer_reference(x, p, heads, t_valid))


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("res,heads,shift", [(12, 6, 0), (12, 6, 3),
                                             (12, 2, 3), (84, 6, 3)])
def test_fusion_block_kernel(dev, cross, res, heads, shift):
    gen = torch.Generator().manual_seed(res + heads + shift + cross)
    C, ws = 12, 6
    nW, N = (res // ws) ** 2, ws * ws
    qkv = (_ln(gen, C) + _lin(gen, C, C) + _lin(gen, 2 * C, C) if cross
           else _lin(gen, 3 * C, C))
    p = tuple(t.to(dev) for t in _ln(gen, C) + qkv + _lin(gen, C, C)
              + _ln(gen, C) + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C))
    x, y = (_rand(gen, 2, nW, N, C).to(dev) for _ in "xy")
    bias = _rand(gen, heads, N, N, scale=0.5).to(dev)
    m = shift_attn_mask(res, res, ws, shift)
    mask = None if m is None else torch.from_numpy(m).to(dev)
    if cross:
        got = fb.fused_cross_fusion_block(x, y, p, bias, mask)
        want = fb.cross_fusion_block_reference(x, y, p, bias, mask)
    else:
        got = fb.fused_fusion_block(x, p, bias, mask)
        want = fb.fusion_block_reference(x, p, bias, mask)
    _close(got, want)


@pytest.mark.parametrize("N,nW,heads,D,masked", [
    (36, 4, 3, 4, True), (36, 1, 6, 4, False), (9, 1, 12, 4, False),
    (16, 4, 2, 8, True)])
def test_window_attention_kernel(dev, N, nW, heads, D, masked):
    gen = torch.Generator().manual_seed(N + nW + heads)
    shape = (2, nW, heads, N, D)
    q, k, v = (_rand(gen, *shape).to(dev) for _ in "qkv")
    bias = _rand(gen, heads, N, N).to(dev)
    mask = (torch.where(torch.rand(nW, N, N, generator=gen) > 0.8, -100.0,
                        0.0).to(dev) if masked else None)
    _close(att.fused_window_attention(q, k, v, bias, mask),
           att.attention_reference(q, k, v, bias, mask))


def test_wrappers_check_dtype_and_layout(dev):
    q = torch.zeros(1, 1, 1, 9, 4, device=dev)
    bias = torch.zeros(1, 9, 9, device=dev)
    with pytest.raises(TypeError, match="float32"):
        att.fused_window_attention(q.double(), q, q, bias)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 1, 1, 4, 9, device=dev).transpose(-1, -2)
        att.fused_window_attention(t, q, q, bias)
    with pytest.raises(ValueError, match="shape"):
        att.fused_window_attention(q, q, q, torch.zeros(2, 9, 9, device=dev))


def test_predictor_on_the_card_matches_the_cpu(dev, tmp_path):
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import save_checkpoint
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    cfg = Config(task="FuncStruct", dataset_name="multimodal",
                 transformer_hidden_layers=2, bert_intermediate_size=128,
                 num_heads_2DBert=4, intermediate_vec=48,
                 fusion_ex_depths=(2,), fusion_depths=(1,),
                 fusion_re_depths=(1,), fusion_ex_heads=(2,),
                 fusion_heads=(2,), fusion_re_heads=(2,),
                 size_of_model="small", batch_size=2,
                 compute_dtype="float32", preprocess="host").validate()
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), model.state_dict(),
                           {"val_threshold": 0.5})
    rng = np.random.default_rng(0)
    reqs = [{"subject": f"s{i}", "fmri": rng.normal(size=(48, 360)),
             "struct": rng.normal(size=(48, 48))} for i in range(3)]
    ops.reset_launches()
    got = Predictor(cfg, ckpt, reqs, device="cuda").predict()
    assert all(n > 0 for n in ops.launches().values()), ops.launches()
    want = Predictor(cfg, ckpt, reqs, device="cpu").predict()
    for s in want:
        np.testing.assert_allclose(got[s]["score"], want[s]["score"],
                                   rtol=1e-4, atol=1e-5)
