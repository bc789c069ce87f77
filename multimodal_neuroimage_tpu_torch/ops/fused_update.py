"""K5: the fused Adam / AdamW update over one flat parameter buffer.

Counterpart of multimodal_neuroimage_tpu/ops/fused_update.py ``fused_adam``
(``_kernel`` / ``_fused_flat_update``). ``FusedAdam`` keeps every parameter,
its gradient and both moments in four flat float32 buffers: each parameter
and its ``.grad`` are views into them (as DDP's gradient_as_bucket_view
does), so autograd accumulates straight into the flat gradient and the
whole update is one launch of ``csrc/fused_update.cu`` on the card, or
``fused_adam_reference`` (the plain version) on the CPU.

The math and its order are the JAX kernel's: the clip factor and the bias
corrections are scalars computed outside the kernel, torch-Adam L2 goes into
the gradient, AdamW's decay is decoupled and added after the bias
correction, and the LR is the schedule at the pre-increment count. The
update is IN PLACE on the parameters and both moments.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.ops import build


def _f32(v: float) -> float:
    """v rounded to float32 (how JAX rounds a Python float against an f32
    array)."""
    return float(np.float32(v))


def fused_adam_reference(p, g, mu, nu, clip: Optional[torch.Tensor],
                         lr: float, bc1: float, bc2: float, b1: float,
                         b2: float, eps: float, wd: float, adamw: bool
                         ) -> None:
    """Plain PyTorch version of the update, in place on p, mu and nu; one
    rounding a product or sum, in the kernel's order."""
    if clip is not None:
        g = g * clip
    wd = _f32(wd)
    if not adamw and wd != 0.0:
        g = g + wd * p
    m = _f32(b1) * mu + _f32(1.0 - b1) * g
    v = _f32(b2) * nu + _f32(1.0 - b2) * (g * g)
    u = (m * _f32(bc1)) / (torch.sqrt(v * _f32(bc2)) + _f32(eps))
    if adamw and wd != 0.0:
        u = u + wd * p
    p.add_(-_f32(lr) * u)
    mu.copy_(m)
    nu.copy_(v)


def fused_adam_update(p, g, mu, nu, clip: Optional[torch.Tensor], lr: float,
                      bc1: float, bc2: float, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8, wd: float = 0.0,
                      adamw: bool = True) -> None:
    """One K5 update of flat buffers, in place: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. ``clip`` is a one-element
    tensor (the clip factor) or None."""
    if p.device.type == "cpu":
        fused_adam_reference(p, g, mu, nu, clip, lr, bc1, bc2, b1, b2, eps,
                             wd, adamw)
        return
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        build.check_cuda_f32(name, t, (n,))
    if clip is not None:
        build.check_cuda_f32("clip", clip, (1,))
    build.library().call(
        "fused_adam_update", p.data_ptr(), g.data_ptr(), mu.data_ptr(),
        nu.data_ptr(), n, None if clip is None else clip.data_ptr(),
        _f32(lr), _f32(bc1), _f32(bc2), float(b1), float(b2), float(eps),
        float(wd), int(adamw), build.stream_of(p))
    fused_adam_update.launches += 1


fused_adam_update.launches = 0


class FusedAdam:
    """Adam ("adam": L2 into the gradient) or AdamW ("adamw": decoupled
    decay) over flat buffers, with optional global-norm clipping.

    With ``accumulation_steps`` k > 1 it is JAX's ``optax.MultiSteps`` over
    the same chain: each ``step()`` folds the micro-step's gradient into
    the running mean ``acc`` as MultiSteps does (``acc += (g - acc) / (m +
    1)`` at mini-step m, float32), and every k-th applies K5 to that mean
    (clipping on the mean, the schedule at the count of updates) and
    clears it; the other micro-steps leave the parameters alone.

    Construction moves every parameter into ``self.params`` (a flat f32
    buffer on the parameters' device) and binds each ``.grad`` to a view of
    ``self.grads``: build it after the model is on its device, and do not
    move the model afterwards."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], weight_decay: float,
                 mode: str = "adamw", gradient_clipping: bool = False,
                 clip_max_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 accumulation_steps: int = 1):
        mode = mode.lower()
        if mode not in ("adam", "adamw"):
            raise ValueError(f"FusedAdam supports adam/adamw, got {mode!r}")
        self.param_list = list(params)
        if not self.param_list:
            raise ValueError("FusedAdam got no parameters")
        device = self.param_list[0].device
        for p in self.param_list:
            if p.device != device or p.dtype != torch.float32:
                raise ValueError("FusedAdam needs float32 parameters on one "
                                 "device")
        self.schedule = schedule
        self.weight_decay = float(weight_decay)
        self.adamw = mode == "adamw"
        self.gradient_clipping = gradient_clipping
        self.clip_max_norm = float(clip_max_norm)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.count = 0
        self.k = max(int(accumulation_steps), 1)
        self.mini_step = 0
        total = sum(p.numel() for p in self.param_list)
        self.params = torch.empty(total, dtype=torch.float32, device=device)
        self.grads = torch.zeros(total, dtype=torch.float32, device=device)
        self.mu = torch.zeros(total, dtype=torch.float32, device=device)
        self.nu = torch.zeros(total, dtype=torch.float32, device=device)
        self._views = []
        off = 0
        with torch.no_grad():
            for p in self.param_list:
                n = p.numel()
                self.params[off:off + n].copy_(p.reshape(-1))
                p.data = self.params[off:off + n].view_as(p)
                self._views.append(self.grads[off:off + n].view_as(p))
                off += n
        self.acc = (torch.zeros(total, dtype=torch.float32, device=device)
                    if self.k > 1 else None)
        self.zero_grad()

    def zero_grad(self) -> None:
        self.grads.zero_()
        for p, view in zip(self.param_list, self._views):
            p.grad = view

    def _check_grads(self) -> None:
        for p, view in zip(self.param_list, self._views):
            if p.grad is None or p.grad.data_ptr() != view.data_ptr():
                raise RuntimeError(
                    "a parameter's .grad no longer views the flat gradient "
                    "buffer (was it replaced, or the model moved?)")

    def current_lr(self) -> float:
        return float(self.schedule(self.count))

    def state(self) -> Dict[str, object]:
        """What a checkpoint keeps to resume the optimizer exactly."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state(self, state: Mapping[str, object]) -> None:
        """Restore :meth:`state` (moments, counts, accumulated mean) in
        place."""
        acc = state.get("acc")
        if (tuple(state["mu"].shape) != tuple(self.mu.shape)
                or (acc is None) != (self.acc is None)):
            raise ValueError(
                f"optimizer state of {tuple(state['mu'].shape)} elements"
                f"{' with' if acc is not None else ' without'} an "
                f"accumulated gradient does not fit this optimizer "
                f"({self.mu.numel()} elements, accumulation_steps {self.k})")
        with torch.no_grad():
            self.mu.copy_(state["mu"])
            self.nu.copy_(state["nu"])
            if acc is not None:
                self.acc.copy_(acc)
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))

    def step(self) -> None:
        """One micro-step: accumulate, and every k-th apply K5 (module
        docstring); with k = 1 every call applies K5."""
        self._check_grads()
        grads = self.grads
        if self.acc is not None:
            with torch.no_grad():
                self.acc.add_((self.grads - self.acc)
                              / float(self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return
            self.mini_step = 0
            grads = self.acc
        self._update(grads)
        if self.acc is not None:
            self.acc.zero_()

    def _update(self, grads: torch.Tensor) -> None:
        clip = None
        if self.gradient_clipping:
            norm = torch.sqrt(torch.sum(grads * grads))
            clip = torch.where(norm < self.clip_max_norm,
                               torch.ones_like(norm),
                               self.clip_max_norm / torch.clamp(norm,
                                                                min=1e-38))
            clip = clip.reshape(1)
        t = np.float32(self.count + 1)
        one = np.float32(1.0)
        bc1 = one / (one - np.float32(self.b1) ** t)
        bc2 = one / (one - np.float32(self.b2) ** t)
        fused_adam_update(self.params, grads, self.mu, self.nu, clip,
                          self.current_lr(), float(bc1), float(bc2), self.b1,
                          self.b2, self.eps, self.weight_decay, self.adamw)
        self.count += 1
