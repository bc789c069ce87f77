"""The port's count of a step's work (obs/profiling.py ``traced_flops``,
``graph_flops``, ``compiled_cost``) on the CPU.

* Each kernel's formula (ops/flops.py) equals torch's ``FlopCounterMode``
  count of its plain version, forward and forward + backward (autograd
  through the plain forward, every input taking a gradient), at two shapes
  a form: K1 float32 and mm16 at head dims 7, 14 and 21; K2 and K3 at
  shift 0 and 3 (no mask, a shift mask); K4; K6 float32 and bf16; K7 on
  float32 and bf16 streams; K8.
* Each registered op of ops/library.py counts by its kernel's formula,
  for torch's ``FlopCounterMode`` as for the census; K5 counts 0.
* Through its wrapper, on a CPU tensor, ``traced_flops`` counts a kernel by
  its formula, and ``compiled_cost`` counts what the plain versions run:
  the forward alike, a backward with the plain backward's recompute of its
  forward in addition (and, in K7's bf16 backward, fc1 once more from the
  bf16 x2r).
* The port's ``traced_flops`` of the training and the predict step equals
  JAX's ``traced_flops`` of JAX's steps on the same config and batch, for
  the tiny flagship (float32, bf16, and the bp layout), a tiny HCP
  ``TransformerNet`` (K6's route), ``smri_swin`` (SwinV2 on sMRI) and
  ``swinfusion_struct`` (SwinFusionNet, tiny depths). JAX runs as its own
  tests run it on the CPU: its default route, the plain jnp versions of
  its kernels. The equality is exact, with no term: JAX's census counts
  ``dot_general`` only, neither of them counts a convolution, and JAX's
  VJP recomputes nothing.
* ``graph_flops`` of the tiny flagship's and the tiny HCP net's exported
  predict step (serve/export.py, registered ops and portable) equals
  ``traced_flops`` of the live step and of the artifact; a ``cond`` counts
  its larger branch; ``compiled_cost`` equals ``traced_flops`` for a
  forward on the CPU.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from __graft_entry__ import _example_batch, _flagship_cfg
from multimodal_neuroimage_tpu.config import Config as JConfig
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.obs.profiling import traced_flops as jtraced
from multimodal_neuroimage_tpu.serve.predictor import (
    make_predict_step as jpredict_step)
from multimodal_neuroimage_tpu.train.losses import active_losses as jlosses
from multimodal_neuroimage_tpu.train.state import (create_train_state,
                                                   make_train_step as
                                                   jtrain_step,
                                                   optimizer_from_config)
from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import save_checkpoint
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.models.registry import (
    create_model, init_random_weights)
from multimodal_neuroimage_tpu_torch.nn import swinfusion as tsf
from multimodal_neuroimage_tpu_torch.obs.profiling import (
    Census, compiled_cost, graph_flops, traced_flops)
from multimodal_neuroimage_tpu_torch.ops import attention as att
from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds
from multimodal_neuroimage_tpu_torch.ops import flops
from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
from multimodal_neuroimage_tpu_torch.serve.export import (export_model,
                                                          load_exported)
from multimodal_neuroimage_tpu_torch.serve.predictor import (
    Predictor, make_predict_step)
from multimodal_neuroimage_tpu_torch.train.losses import active_losses
from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                         make_train_step)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _stream_policies():
    """The steps set both packages' fusion-stream policies
    (``nn/swinfusion.py`` ``_POLICY16``, module globals); each test leaves
    them as it found them for the next test in this process."""
    import multimodal_neuroimage_tpu.nn.swinfusion as jsf
    saved = (jsf._POLICY16, tsf._POLICY16)
    yield
    jsf._POLICY16, tsf._POLICY16 = saved


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _leaves(*shapes, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g).to(dtype).requires_grad_()
            for s in shapes]


def _fwd_bwd(plain, inputs):
    """fn() running ``plain`` forward and its autograd backward."""
    def run():
        out = plain()
        out.backward(torch.ones_like(out))
        for t in inputs:
            t.grad = None
    return run


# ---- each kernel's formula against its plain version --------------------------

def _bert(B, T, heads, hd, F, mm16, seed=0):
    H = heads * hd
    shapes = ([(H, H), (H,)] * 4 + [(H,), (H,), (F, H), (F,), (H, F), (H,),
                                    (H,), (H,)])
    x, *params = _leaves((B, T, H), *shapes, seed=seed)
    plain = lambda: bl.bert_layer_reference(x, params, heads, T - 2, mm16=mm16)
    wrapper = lambda: bl.bert_layer_call(x, params, heads, T - 2, mm16=mm16)
    return (x, *params), plain, wrapper, flops.bert_layer(B, T, H, F)


def _block(B, nW, N, C, heads, Ch, cross, shift, seed=0):
    vec, mat = (lambda n: (n,)), (lambda o, i: (o, i))
    qkv = ([vec(C), vec(C), mat(C, C), vec(C), mat(2 * C, C), vec(2 * C)]
           if cross else [mat(3 * C, C), vec(3 * C)])
    shapes = ([vec(C), vec(C)] + qkv + [mat(C, C), vec(C), vec(C), vec(C),
                                        mat(Ch, C), vec(Ch), mat(C, Ch),
                                        vec(C)])
    x, y, bias, *params = _leaves((B, nW, N, C), (B, nW, N, C),
                                  (heads, N, N), *shapes, seed=seed)
    mask = (torch.randn(nW, N, N, generator=torch.Generator().manual_seed(9))
            if shift else None)
    return x, (y if cross else None), bias, mask, params


@pytest.mark.parametrize("shape", [(2, 9, 2, 24), (1, 17, 3, 32)],
                         ids=["B2T9", "B1T17"])
@pytest.mark.parametrize("hd", [7, 14, 21])
@pytest.mark.parametrize("mm16", [False, True], ids=["f32", "mm16"])
def test_k1_formula_is_its_plain_version(shape, hd, mm16):
    B, T, heads, F = shape
    inputs, plain, wrapper, fwd = _bert(B, T, heads, hd, F, mm16)
    assert _counted(plain) == fwd
    bwd = flops.bert_layer(B, T, heads * hd, F, backward=True)
    assert _counted(_fwd_bwd(plain, inputs)) == fwd + bwd
    assert traced_flops(_fwd_bwd(wrapper, inputs)) == fwd + bwd
    # the plain backward recomputes its forward
    assert compiled_cost(_fwd_bwd(wrapper, inputs))["flops"] == 2 * fwd + bwd


@pytest.mark.parametrize("shape", [(2, 4, 9, 8, 2, 32), (1, 3, 36, 12, 3, 48)],
                         ids=["N9", "N36"])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("cross", [False, True], ids=["K2", "K3"])
def test_k2_k3_formula_is_its_plain_version(shape, shift, cross):
    B, nW, N, C, heads, Ch = shape
    x, y, bias, mask, params = _block(B, nW, N, C, heads, Ch, cross, shift)
    inputs = [x, bias, *params] + ([y] if cross else [])
    plain = lambda: fb._block_reference(x, y, params, bias, mask, None, 0,
                                        (0.0, 0.0), False, cross)
    fwd = flops.fusion_block(B, nW, N, C, Ch)
    bwd = flops.fusion_block(B, nW, N, C, Ch, backward=True)
    assert _counted(plain) == fwd
    assert _counted(_fwd_bwd(plain, inputs)) == fwd + bwd
    call = ((lambda: fb.fused_cross_fusion_block(x, y, params, bias, mask))
            if cross else (lambda: fb.fused_fusion_block(x, params, bias,
                                                         mask)))
    assert traced_flops(_fwd_bwd(call, inputs)) == fwd + bwd
    assert compiled_cost(_fwd_bwd(call, inputs))["flops"] == 2 * fwd + bwd


@pytest.mark.parametrize("shape", [(2, 4, 3, 9, 4), (1, 1, 6, 36, 8)],
                         ids=["N9", "N36"])
@pytest.mark.parametrize("masked", [False, True])
def test_k4_formula_is_its_plain_version(shape, masked):
    B, nW, H, N, D = shape
    q, k, v, bias = _leaves(*[(B, nW, H, N, D)] * 3, (H, N, N))
    mask = torch.randn(nW, N, N) if masked else None
    plain = lambda: att.attention_reference(q, k, v, bias, mask)
    fwd = flops.attention(B * nW, H, N, N, D)
    bwd = flops.attention(B * nW, H, N, N, D, backward=True)
    assert _counted(plain) == fwd
    assert _counted(_fwd_bwd(plain, (q, k, v, bias))) == fwd + bwd
    call = lambda: att.fused_window_attention(q, k, v, bias, mask)
    assert traced_flops(_fwd_bwd(call, (q, k, v, bias))) == fwd + bwd
    assert compiled_cost(_fwd_bwd(call, (q, k, v, bias)))["flops"] == (
        2 * fwd + bwd)
    with torch.no_grad():       # inference: the launch without the Function
        assert traced_flops(call) == compiled_cost(call)["flops"] == fwd


@pytest.mark.parametrize("shape", [(2, 2, 33, 11), (1, 3, 64, 16)],
                         ids=["T33", "T64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k6_formula_is_its_plain_version(shape, dtype):
    B, H, T, D = shape
    q, k, v = _leaves(*[(B, H, T, D)] * 3, dtype=dtype)
    plain = ((lambda: att.mha_reference16(q, k, v))
             if dtype == torch.bfloat16 else
             (lambda: att.mha_reference(q, k, v)))
    fwd = flops.attention(B, H, T, T, D)
    bwd = flops.attention(B, H, T, T, D, backward=True)
    assert _counted(plain) == fwd
    assert _counted(_fwd_bwd(plain, (q, k, v))) == fwd + bwd
    call = lambda: att.fused_attention(q, k, v)
    assert traced_flops(_fwd_bwd(call, (q, k, v))) == fwd + bwd
    assert compiled_cost(_fwd_bwd(call, (q, k, v)))["flops"] == 2 * fwd + bwd


@pytest.mark.parametrize("shape", [(4, 2, 4, 9, 8, 2, 32),
                                   (2, 2, 1, 36, 12, 3, 48)],
                         ids=["G2N9", "G2N36"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k7_formula_is_its_plain_version(shape, cross, dtype):
    B, G, nW, N, C, heads, Ch = shape
    x, y, bias, mask, params = _block(B, nW, N, C, heads, Ch, cross, 3)
    xg, yg = (fbp.to_groups(t.detach(), G).to(dtype).requires_grad_()
              if t is not None else None for t in (x, y))
    inputs = [xg, bias, *params] + ([yg] if cross else [])
    if dtype == torch.bfloat16:
        plain = lambda: fbp.fusion_block_bp_reference16(
            xg, params, bias, mask, y=yg, group=G)[0]
    else:
        plain = lambda: fbp._bp_reference(xg, yg, params, bias, mask, None,
                                          0, (0.0, 0.0), False, cross, G)
    fwd = flops.fusion_block(B, nW, N, C, Ch)
    bwd = flops.fusion_block(B, nW, N, C, Ch, backward=True)
    assert _counted(plain) == fwd
    assert _counted(_fwd_bwd(plain, inputs)) == fwd + bwd
    call = ((lambda: fbp.fused_cross_fusion_block_bp(xg, yg, params, bias,
                                                     mask, group=G))
            if cross else (lambda: fbp.fused_fusion_block_bp(
                xg, params, bias, mask, group=G)))
    assert traced_flops(_fwd_bwd(call, inputs)) == fwd + bwd
    # the bf16 plain backward takes fc1 once more from the bf16 x2r
    # (JAX's bp backward kernel with mm16 recomputes u there)
    fc1_again = 2 * B * nW * N * C * Ch if dtype == torch.bfloat16 else 0
    assert compiled_cost(_fwd_bwd(call, inputs))["flops"] == (
        2 * fwd + bwd + fc1_again)


@pytest.mark.parametrize("a_shape,b_shape", [
    ((4, 3, 8, 16), (4, 3, 16, 5)), ((2, 36, 12), (2, 12, 36))],
    ids=["4d", "3d"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k8_formula_is_its_plain_version(a_shape, b_shape, bf16):
    a, b = _leaves(a_shape, b_shape)
    batch = int(np.prod(a_shape[:-2]))
    want = flops.batched_matmul(batch, a_shape[-2], b_shape[-1], a_shape[-1])
    assert _counted(lambda: torch.matmul(a, b)) == want
    call = lambda: ds.batched_matmul(a, b, 0.5, bf16)
    assert traced_flops(call) == compiled_cost(call)["flops"] == want


def test_registered_ops_count_by_their_formulas():
    """torch's ``FlopCounterMode`` and the census read each registered op
    of ops/library.py (an exported program's kernels) by its kernel's
    formula."""
    from multimodal_neuroimage_tpu_torch.ops import library
    with torch.no_grad():
        (x, *p), _, _, k1 = _bert(2, 9, 2, 7, 32, False)
        xs, _, bias, mask, sp = _block(2, 4, 9, 8, 2, 32, False, 3)
        xc, y, _, _, cp = _block(2, 4, 9, 8, 2, 32, True, 3)
        q = torch.randn(2, 4, 2, 9, 4)
        h = torch.randn(2, 3, 33, 8)
        cases = (
            (lambda: library.bert_layer_forward(x, p, 2, 7, False), k1),
            (lambda: library.fusion_block_forward(xs, None, sp, bias, mask),
             flops.fusion_block(2, 4, 9, 8, 32)),
            (lambda: library.fusion_block_forward(xc, y, cp, bias, mask),
             flops.fusion_block(2, 4, 9, 8, 32)),
            (lambda: library.window_attention_forward(q, q, q, bias, mask),
             flops.attention(8, 2, 9, 9, 4)),
            (lambda: library.mha_forward(h, h, h),
             flops.attention(2, 3, 33, 33, 8)),
            (lambda: library.fusion_block_bp_forward(
                fbp.to_groups(xs, 2), None, sp, bias, mask, 2),
             flops.fusion_block(2, 4, 9, 8, 32)))
        for call, want in cases:
            assert _counted(call) == traced_flops(call) == want
            assert compiled_cost(call)["flops"] == 0


def test_k5_counts_no_product():
    from multimodal_neuroimage_tpu_torch.ops import fused_update as fu
    p, g, mu, nu = (torch.randn(1000) for _ in range(4))
    call = lambda: fu.fused_adam_update(p, g, mu, nu, None, 1e-3, 1.0, 1.0)
    with Census() as census:
        call()
    assert census.total == 0 and census.kernels == {"K5 fused_adam": 0}


# ---- whole steps against JAX -------------------------------------------------------

TINY_FUSION = dict(fusion_ex_depths=(1,), fusion_depths=(1,),
                   fusion_re_depths=(1,), fusion_ex_heads=(2,),
                   fusion_heads=(2,), fusion_re_heads=(2,))


def _setup(name, compute_dtype):
    """(JAX config, numpy batch of 4) of a bench.py config at test size."""
    rng = np.random.default_rng(0)
    target = rng.integers(0, 2, 4).astype(np.float32)
    kw = dict(target="sex", fine_tune_task="binary_classification",
              batch_size=4, compute_dtype=compute_dtype, preprocess="host")
    if name == "flagship":
        cfg = dataclasses.replace(_flagship_cfg(tiny=True),
                                  compute_dtype=compute_dtype,
                                  preprocess="host").validate()
        return cfg, _example_batch(4, t=32, r=cfg.intermediate_vec)
    if name == "hcp":
        cfg = JConfig(step=1, task="2DBERT", dataset_name="hcp",
                      transformer_hidden_layers=1, bert_intermediate_size=32,
                      **kw).validate()
        return cfg, {"fmri_sequence": rng.normal(size=(
            4, cfg.sequence_length, cfg.intermediate_vec)).astype(np.float32),
            "target": target}
    if name == "smri_swin":
        cfg = JConfig(task="VIT", dataset_name="sMRI", **kw).validate()
        return cfg, {"smri": rng.normal(size=(4, 84, 84)).astype(np.float32),
                     "target": target}
    cfg = JConfig(task="SwinFusion", dataset_name="struct", **TINY_FUSION,
                  **kw).validate()
    return cfg, {k: rng.normal(size=(4, 84, 84)).astype(np.float32)
                 for k in ("smri", "dti")} | {"target": target}


def _jax_counts(cfg, batch):
    model = jcreate(cfg)
    tx, _ = optimizer_from_config(cfg, steps_per_epoch=10)
    state = create_train_state(model, batch, tx, cfg.seed)
    train = jtrain_step(model, jlosses(cfg.task, cfg.fine_tune_task),
                        compute_dtype=cfg.compute_dtype, donate=False)
    predict = jpredict_step(model, cfg.compute_dtype)
    return (jtraced(train, state, batch),
            jtraced(predict, state.params, batch))


def _port(cfg):
    pcfg = Config(**dataclasses.asdict(cfg))
    model = init_random_weights(create_model(pcfg),
                                torch.Generator().manual_seed(1))
    opt = create_optimizer(pcfg.optim, model.parameters(), lambda t: 1e-3,
                           1e-5)
    train = make_train_step(model, active_losses(pcfg.task,
                                                 pcfg.fine_tune_task),
                            opt, pcfg.compute_dtype, "cpu")
    return pcfg, model, train, make_predict_step(model, pcfg.compute_dtype,
                                                 "cpu")


@pytest.fixture
def layout(request):
    saved = tsf._LAYOUT
    tsf._LAYOUT = request.param
    yield request.param
    tsf._LAYOUT = saved


@pytest.mark.parametrize("name,compute_dtype,layout", [
    ("flagship", "float32", "std"), ("flagship", "bfloat16", "std"),
    ("flagship", "float32", "bp"), ("flagship", "bfloat16", "bp"),
    ("hcp", "float32", "std"), ("hcp", "bfloat16", "std"),
    ("smri_swin", "float32", "std"), ("swinfusion_struct", "float32", "std"),
], indirect=["layout"])
def test_step_counts_equal_jax(name, compute_dtype, layout):
    cfg, batch = _setup(name, compute_dtype)
    want_train, want_predict = _jax_counts(cfg, batch)
    _, _, train, predict = _port(cfg)
    assert traced_flops(predict, batch) == want_predict
    # the library sees the plain versions: a forward's products alike
    assert compiled_cost(predict, batch)["flops"] == want_predict
    with Census() as census:
        train(batch, torch.Generator().manual_seed(0))
    assert census.total == want_train
    kernels = {k for k, n in census.kernels.items() if n}
    assert kernels, "no kernel on the path"
    if layout == "bp" and name == "flagship":
        assert all(not k.startswith(("K2", "K3")) for k in kernels), kernels


def test_compiled_cost_of_a_training_step_adds_the_recompute():
    """On the CPU the plain backwards recompute their forward: the
    library's count of a float32 training step exceeds ``traced_flops`` by
    the forward formulas of the kernels that ran backward."""
    cfg, batch = _setup("flagship", "float32")
    _, _, train, _ = _port(cfg)
    with Census() as census:
        train(batch, torch.Generator().manual_seed(0))

    def backward(name):
        for form in (" mm16", " bf16"):
            if name.endswith(form):
                return name[:-len(form)] + " backward" + form
        return name + " backward"

    recompute = sum(n for k, n in census.kernels.items()
                    if "backward" not in k and backward(k) in census.kernels)
    got = compiled_cost(train, batch, torch.Generator().manual_seed(0))
    assert recompute > 0
    assert got["flops"] == census.total + recompute


# ---- graph_flops -------------------------------------------------------------------

def _predictor(kind, compute_dtype, tmp_path):
    if kind == "hcp":
        cfg = Config(step=1, task="2DBERT", dataset_name="hcp", target="sex",
                     batch_size=2, transformer_hidden_layers=1,
                     compute_dtype=compute_dtype, preprocess="host").validate()
        rng = np.random.default_rng(2)
        records = [{"subject": f"s{i}", "fmri": rng.normal(size=(22, 1100))}
                   for i in range(2)]
    else:
        jcfg = dataclasses.replace(_flagship_cfg(tiny=True), batch_size=2,
                                   compute_dtype=compute_dtype,
                                   preprocess="host").validate()
        cfg = Config(**dataclasses.asdict(jcfg))
        rng = np.random.default_rng(2)
        R = cfg.intermediate_vec
        records = [{"subject": f"s{i}", "fmri": rng.normal(size=(R, 300)),
                    "struct": rng.normal(size=(R, R))} for i in range(2)]
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(1))
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), model.state_dict(),
                           {"val_threshold": 0.5})
    return Predictor(cfg, ckpt, records, device="cpu")


@pytest.mark.parametrize("kind,compute_dtype", [
    ("flagship", "float32"), ("flagship", "bfloat16"), ("hcp", "float32")])
@pytest.mark.parametrize("portable", [False, True],
                         ids=["registered_ops", "portable"])
def test_graph_flops_of_the_artifact_equal_the_live_step(kind, compute_dtype,
                                                         portable, tmp_path):
    pred = _predictor(kind, compute_dtype, tmp_path)
    batch, _ = next(pred.batches())
    live = traced_flops(pred.step, batch)
    path = export_model(pred, str(tmp_path / "m.pt2"), portable=portable)
    art = load_exported(path)
    assert graph_flops(art.program) == art.meta["flops"] == live
    # the same census over the graph decomposed to core ATen
    assert graph_flops(art.program.run_decompositions().graph_module) == live
    with Census() as census:
        art(batch)
    assert census.total == live
    assert compiled_cost(pred.step, batch)["flops"] == live
    # the library cannot see into a registered op
    share = sum(census.kernels.values())
    assert (share == 0) == portable
    assert compiled_cost(art, batch)["flops"] == live - share


class _Branches(torch.nn.Module):
    def forward(self, x, w):
        return torch.cond(x.sum() > 0, lambda x, w: x @ w @ w,
                          lambda x, w: x @ w, (x, w))


def test_graph_flops_counts_the_larger_branch_of_a_cond():
    x, w = torch.randn(5, 8), torch.randn(8, 8)
    program = torch.export.export(_Branches(), (x, w))
    assert graph_flops(program) == 2 * (2 * 5 * 8 * 8)
