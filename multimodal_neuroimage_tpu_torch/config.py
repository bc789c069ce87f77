"""Typed configuration tree with per-phase overlays (the port's own copy of
multimodal_neuroimage_tpu/config.py).

The same fields, defaults, ``validate()`` and phase overlays as the JAX
package's ``Config``, so one experiment description drives either package;
tests/test_torch_hcp.py holds the two copies equal. It replaces the
reference's argparse schema (reference main.py:24-332) and its
``_phase{N}`` suffix convention resolved by ``sort_args`` (reference
utils.py:144-151). Booleans that the reference made ON-by-default through
``action='store_false'`` (``--amp`` main.py:88, ``--random_TR`` main.py:60,
``--attn_mask`` main.py:194, ``--no_init_weights`` main.py:205) are explicit
defaults here. Fields that only the JAX package reads (mesh, SPMD mode,
flat/fused optimizer switches, profiling) are kept so that configurations
carry over unchanged.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# Phase table (reference main.py:43, utils.py:95-128)
# ---------------------------------------------------------------------------

PHASE_TASKS = {
    1: "2DBERT",
    2: "lowfreqBERT",
    3: "VIT",
    4: "test",
    5: "FuncStruct",
    6: "SwinFusion",
}


@dataclass
class Config:
    """Flat experiment configuration.

    Field names intentionally mirror the reference's kwargs so that the model
    dispatch and data routing logic (reference trainer.py:176-266, 475-537)
    reads one-to-one.
    """

    # ---- experiment identity -------------------------------------------------
    exp_name: str = "baseline"
    base_path: str = "."
    step: int = 1
    task: str = "2DBERT"                      # derived from step via PHASE_TASKS
    seed: int = 55555555                      # reference main.py:53

    # ---- data ----------------------------------------------------------------
    dataset_name: str = "fMRI_timeseries"     # choices main.py:32
    fmri_type: str = "timeseries"             # choices main.py:33
    intermediate_vec: int = 84                # ROI count / BERT hidden (main.py:34)
    target: str = "sex"                       # main.py:48
    fine_tune_task: str = "binary_classification"
    sequence_length: int = 368                # ABCD pad target (datasets.py:222-229)
    train_split: float = 0.7                  # main.py:71
    val_split: float = 0.15                   # main.py:72
    batch_size: int = 8
    workers: int = 4
    augment_prob: float = 0.0
    filtering_type: str = "FIR"               # FIR | Boxcar (main.py:166)
    fir_lb_hz: float = 0.0035                 # highpass cut (datasets.py:245)
    tr_seconds: float = 0.8                   # sampling interval (datasets.py:234)
    fir_order: int = 64                       # nitime FilterAnalyzer default
    # data locations (synthetic-friendly defaults; reference main.py:35-41)
    fmri_timeseries_path: str = "./data/fmri_timeseries"
    fmri_image_path: str = "./data/fmri_image"
    dti_path: str = "./data/dti"
    smri_path: str = "./data/smri_cortical_thickness"
    dti_smri_path: str = "./data/dti+smri"
    prs_path: str = "./data/prs"
    hcp_path: str = "./data/hcp"
    metadata_csv: str = ""                    # ABCD_phenotype_total.csv location
    subject_list_path: str = ""               # multimodal_sub_list.txt location
    # preprocessing placement: 'device' = fused on-TPU FIR/zscore,
    # 'host' = numpy per item, 'native' = C++ batch pipeline (native/fastpipe)
    preprocess: str = "device"
    prefetch_depth: int = 2                   # double-buffered device prefetch

    # ---- fMRI model ------------------------------------------------------------
    transformer_hidden_layers: int = 16       # main.py:68
    transformer_dropout_rate: float = 0.1     # main.py:225
    # HF attention_probs_dropout_prob — the reference leaves the HF default
    # 0.1 un-wired (model.py:62); exposed here so it's controllable
    bert_attn_dropout: float = 0.1
    bert_intermediate_size: int = 3072        # HF BertConfig default kept by reference
    num_heads_2DBert: int = 12                # main.py:223
    num_heads_mult: int = 12                  # main.py:192
    feature_squeeze: bool = False             # main.py:224
    fmri_multimodality_type: str = "cross_attention"   # main.py:101
    feature_map_gen: str = "convolution_ul+l"  # main.py:162
    feature_map_size: str = "same"            # main.py:163
    mixing: str = "U2L_and_L2U"               # main.py:164
    concat_method: str = "concat"             # main.py:165
    nlevels: int = 12                         # crossmodal layers (main.py:190)
    attn_dropout: float = 0.1                 # main.py:176
    attn_dropout_u: float = 0.0               # main.py:178
    relu_dropout: float = 0.1                 # main.py:180
    embed_dropout: float = 0.25               # main.py:182
    res_dropout: float = 0.1                  # main.py:184
    out_dropout: float = 0.0                  # main.py:186
    attn_mask: bool = True                    # main.py:194 (store_false)
    use_merge_loss: bool = False              # main.py:243
    use_cont_loss: bool = False               # main.py:260
    use_mask_loss: bool = False               # main.py:261

    # ---- Swin / fusion ----------------------------------------------------------
    VIT_name: str = "swinv2"                  # main.py:262
    swin_embed_dim: int = 12                  # main.py:198
    patch_size: int = 7                       # main.py:199
    window_size: int = 6                      # main.py:204
    mlp_ratio: float = 4.0                    # main.py:202
    drop_rate: float = 0.0                    # main.py:200
    attn_drop_rate: float = 0.0               # main.py:201
    drop_path_rate: float = 0.0               # main.py:203
    size_of_model: str = "large"              # small|medium|large (main.py:306)
    init_weights: bool = True                 # main.py:205 no_init_weights store_false
    fusion_embed_dim: int = 12                # SwinFusion embed (model.py:1160)
    fusion_ex_depths: Tuple[int, ...] = (6, 6)
    fusion_depths: Tuple[int, ...] = (2, 2, 2)
    fusion_re_depths: Tuple[int, ...] = (6, 6)
    fusion_ex_heads: Tuple[int, ...] = (6, 6)
    fusion_heads: Tuple[int, ...] = (6, 6, 6)
    fusion_re_heads: Tuple[int, ...] = (6, 6)
    fusion_drop_rate: float = 0.1             # Func_Struct_Cross default (model.py:1591)
    fusion_attn_drop_rate: float = 0.1
    fusion_drop_path_rate: float = 0.1

    # ---- multimodal combiners -----------------------------------------------------
    multimodality_type: str = "cross_attention"  # add|cross_attention|transfer (main.py:102)
    use_FC: bool = False                      # main.py:299
    use_unet: bool = False                    # main.py:324
    use_vae: bool = False                     # main.py:323
    use_unet_loss: bool = False               # main.py:300
    use_unet_function: bool = False           # main.py:301
    use_unet_struct: bool = False             # main.py:302
    use_prs: bool = False                     # main.py:303
    prs_unsqueeze: str = "single_convolution"  # main.py:304
    prs_concat_method: str = "add"            # main.py:305

    # ---- optimization ---------------------------------------------------------------
    optim: str = "AdamW"
    lr_init: float = 1e-3
    lr_policy: str = "step"                   # step|SGDR|OneCycle|CosAnn
    lr_gamma: float = 0.97
    lr_step: int = 500
    lr_warmup: Optional[int] = 500
    lr_T_mult: int = 1
    lr_final: float = 1e-7                    # floor (learning_rate.py:20)
    weight_decay: float = 1e-5
    nEpochs: int = 20
    validation_frequency: int = 10_000_000
    accumulation_steps: int = 1               # main.py:95
    gradient_clipping: bool = False           # main.py:89
    clip_max_norm: float = 1.0                # main.py:90
    compute_dtype: str = "bfloat16"           # replaces CUDA AMP (trainer.py:378-409)
    remat: bool = False                       # jax.checkpoint the encoder stacks
    flatten_optimizer: bool = True            # one flat-vector optax update
    fused_optimizer: str = "auto"             # "auto"|"on"|"off": single-
    # Pallas-kernel flat update (ops/fused_update.py) replacing the ~15-pass
    # optax chain; auto = on for adam/adamw without grad accumulation
    fresh_opt_state: bool = False             # explicit opt-in: resume a
    # checkpoint whose opt_state is incompatible with the current optimizer
    # by RESTARTING Adam moments + the LR schedule count (otherwise the
    # trainer retries with the unfused optimizer, then fails loudly)

    # ---- losses ------------------------------------------------------------------
    intensity_factor: float = 1.0
    perceptual_factor: float = 1.0
    reconstruction_factor: float = 1.0
    which_perceptual: str = "vgg"
    vgg_weights_npz: str = ""                 # VGG16 stage weights for the
    # perceptual loss (reference relies on torchvision pretrained VGG16,
    # losses.py:92); empty -> random-feature smoke mode

    # ---- runtime / parallelism ------------------------------------------------------
    distributed: bool = False                 # multi-process (pod) mode
    mesh_shape: Optional[Tuple[int, ...]] = None  # default: all devices on 'data'
    mesh_axes: Tuple[str, ...] = ("data",)
    # how the jitted steps partition over the data axis: "auto" picks
    # shard_map (per-chip fwd+bwd + gradient pmean — required for the Pallas
    # fused kernels, which GSPMD cannot partition) on multi-chip TPU meshes
    # and GSPMD everywhere else; "gspmd"/"shard_map" pin explicitly.
    spmd_mode: str = "auto"
    profiling: bool = False                   # 1 epoch / 10 batches (main.py:98)
    profile_dir: str = ""                     # jax.profiler trace output
    running_mean_size: int = 5000             # main.py:73
    log_dir: str = "runs"
    debug_nans: bool = False
    # wandb.watch equivalent (reference trainer.py:94-97, log_freq=10):
    # log per-module param/grad norms every N train steps; 0 disables
    log_grad_norms_every: int = 0
    # per-step NaN audit forces a device sync per step (the reference's
    # .item() pattern, trainer.py:560-563); False defers syncs to the epoch
    # summary for full step pipelining
    nan_audit: bool = True

    # ---- checkpointing ------------------------------------------------------------
    experiment_folder: str = ""
    experiment_title: str = ""
    model_weights_path: Optional[str] = None  # previous-phase weights (phase chaining)
    strict_chaining: bool = False  # raise instead of falling back to a
    # cross-target checkpoint when phase chaining finds no same-target BEST
    # (guards against a typo'd --target silently training from wrong weights)
    load_cls_embedding: bool = True
    save_last_epoch: bool = True   # rolling *_last_epoch.ckpt for per-epoch
    # crash recovery (reference model.py:111-151); BEST files are unaffected
    predict_only: bool = False     # serving mode: score the cohort with the
    # best checkpoint and write predictions.csv (serve/predictor.py) — no
    # training, labels optional

    # ---- HPO / logging --------------------------------------------------------------
    use_optuna: bool = False
    use_best_params_from_optuna: bool = False
    num_trials: int = 10
    opt_num_epochs: int = 3
    use_wandb: bool = False
    wandb_mode: str = "offline"              # reference --wandb_mode (main.py:116)
    wandb_project: str = "multimodal_neuroimage_tpu"
    wandb_entity: str = ""                   # reference hardcodes a lab entity
    wandb_key: str = ""                      # reference --wandb_key (main.py:115)

    # ---- per-phase overlays (replaces the _phaseN flag suffixes) ----------------------
    phase_overrides: Dict[int, Dict[str, Any]] = field(default_factory=dict)

    def validate(self) -> "Config":
        assert self.dataset_name in {
            "hcp", "fMRI_image", "fMRI_timeseries", "DTI", "sMRI", "struct",
            "DTI+sMRI", "multimodal", "multimodal_prs",
        }, f"unknown dataset {self.dataset_name}"
        assert self.fine_tune_task in {"regression", "binary_classification"}
        assert self.fmri_type in {
            "timeseries", "frequency", "divided_frequency", "time_domain_low",
            "time_domain_ultralow", "frequency_domain_low",
            "frequency_domain_ultralow", "timeseries_and_frequency",
        }
        assert self.intermediate_vec in (84, 48, 22)
        if self.dataset_name == "hcp":
            # HCP series are 22 ROIs (reference datasets.py:114-124); the
            # reference relies on the user passing --intermediate_vec 22 and
            # a compatible head count — default them here instead
            if self.intermediate_vec == 84:
                object.__setattr__(self, "intermediate_vec", 22)
            if self.sequence_length == 368:
                object.__setattr__(self, "sequence_length", 1200)
            for attr in ("num_heads_2DBert", "num_heads_mult"):
                if self.intermediate_vec % getattr(self, attr) != 0:
                    object.__setattr__(self, attr, 2)
        for attr in ("num_heads_2DBert", "num_heads_mult"):
            assert self.intermediate_vec % getattr(self, attr) == 0, (
                f"{attr}={getattr(self, attr)} must divide hidden size "
                f"{self.intermediate_vec} (HF BertSelfAttention contract)")
        assert self.lr_policy in {"step", "SGDR", "OneCycle", "CosAnn"}, \
            f"unknown lr policy {self.lr_policy}"
        assert self.preprocess in {"device", "host", "native"}, \
            f"unknown preprocess placement {self.preprocess}"
        # data-path defaults are base_path-rooted: `--base_path /data/abcd`
        # alone must find /data/abcd/data/... (README flow); explicit
        # absolute or non-"./" paths are left untouched
        if self.base_path not in (".", ""):
            for attr in ("fmri_timeseries_path", "fmri_image_path",
                         "dti_path", "smri_path", "dti_smri_path",
                         "prs_path", "hcp_path"):
                v = getattr(self, attr)
                if v.startswith("./"):
                    object.__setattr__(self, attr,
                                       os.path.join(self.base_path, v[2:]))
        return self


# Per-phase defaults, mirroring the reference's ``_phase{N}`` argument blocks
# (main.py:208-324). Applied on top of the base Config by config_for_phase().
PHASE_DEFAULTS: Dict[int, Dict[str, Any]] = {
    1: dict(task="2DBERT", batch_size=8, nEpochs=20, optim="AdamW",
            weight_decay=1e-5, lr_policy="step", lr_init=1e-3, lr_gamma=0.97,
            lr_step=500, lr_warmup=500, sequence_length=368, workers=4),
    2: dict(task="lowfreqBERT", batch_size=8, nEpochs=20, optim="AdamW",
            weight_decay=1e-5, lr_policy="step", lr_init=1e-3, lr_gamma=0.97,
            lr_step=500, lr_warmup=500, sequence_length=368, workers=4),
    3: dict(task="VIT", batch_size=4, nEpochs=20, optim="Adam",
            weight_decay=1e-5, lr_policy="step", lr_init=1e-4, lr_gamma=0.97,
            lr_step=1000, lr_warmup=500, workers=4),
    4: dict(task="test", batch_size=4, nEpochs=20, optim="AdamW",
            weight_decay=1e-2, lr_policy="step", lr_init=1e-4, lr_gamma=0.9,
            lr_step=1500, lr_warmup=100, sequence_length=368, workers=4),
    5: dict(task="FuncStruct", batch_size=8, nEpochs=20, optim="AdamW",
            weight_decay=1e-5, lr_policy="step", lr_init=1e-3, lr_gamma=0.97,
            lr_step=500, lr_warmup=500, sequence_length=368, workers=4),
    6: dict(task="SwinFusion", batch_size=8, nEpochs=20, optim="AdamW",
            weight_decay=1e-5, lr_policy="step", lr_init=1e-3, lr_gamma=0.97,
            lr_step=500, lr_warmup=500, sequence_length=368, workers=4,
            # standalone SwinFusion keeps its class defaults of 0.8
            # (reference model.py:1161 — kwargs carry no drop_rate at phase 6)
            fusion_drop_rate=0.8, fusion_attn_drop_rate=0.8),
}


def config_for_phase(cfg: Config, step: int,
                     user_set: Optional[set] = None) -> Config:
    """Resolve the phase-specific view of a config.

    Equivalent to the reference's ``sort_args`` stripping ``_phase{N}`` suffixes
    (utils.py:144-151). Precedence (low to high): phase defaults <
    explicitly user-set fields (``user_set`` names, e.g. CLI flags) <
    ``cfg.phase_overrides[step]``.
    """
    fields = {f.name for f in dataclasses.fields(Config)}
    updates: Dict[str, Any] = dict(PHASE_DEFAULTS.get(step, {}))
    for name in (user_set or ()):
        updates.pop(name, None)
    updates.update(cfg.phase_overrides.get(step, {}))
    updates = {k: v for k, v in updates.items() if k in fields}
    updates["step"] = step
    updates["task"] = updates.get("task", PHASE_TASKS.get(step, cfg.task))
    return replace(cfg, **updates).validate()
