"""The phase-driven entry point (counterpart of multimodal_neuroimage_tpu/cli/main.py).

    python -m multimodal_neuroimage_tpu_torch.cli.main --step 3 \
        --dataset_name DTI+sMRI --target sex --exp_name myexp [--device cpu]

``--step N`` selects the phase (1 = 2DBERT, 2 = lowfreqBERT, 3 = VIT,
4 = test, 5 = FuncStruct, 6 = SwinFusion: ``PHASE_TASKS``) and its
hyperparameter defaults (``config_for_phase``); a flag the user sets beats
the phase's default. Every ``Config`` field is a flag, booleans as
``--flag`` / ``--no-flag``. ``--device`` (default ``cuda``) is not a
``Config`` field: it names where the run computes (``cpu`` runs every
kernel's plain version).

A run gets its own folder ``<base_path>/experiments/<exp_name>_<target>_
<YYYYmmdd_HHMMSS, Asia/Seoul>`` (unless ``--experiment_folder`` names one)
holding ``argument_documentation.txt`` and ``arguments.pkl`` (the resolved
config as a dict), the checkpoints and the predictions. Steps 2, 4, 5 and
6 start from the best checkpoint of the phase they chain from (1, 3, 3
and 3: ``weight_loader``), found by the archived arguments of the earlier
runs under ``<base_path>/experiments``; the Trainer merges it with
``partial_restore`` and prints what it copied. Step 4 tests, the other
steps train; ``--predict_only`` serves the cohort into the run's
``predictions.csv``. The files are the JAX package's, so either package
can read the other's ``experiments`` tree (not its checkpoints).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import pickle
from datetime import datetime
from typing import List, Optional, Tuple

from multimodal_neuroimage_tpu_torch.config import (Config, PHASE_TASKS,
                                                    config_for_phase)

CHAIN_FROM = {2: 1, 4: 3, 5: 3, 6: 3}


def datestamp() -> str:
    """Seoul-timezone run stamp (reference utils.py:130)."""
    try:
        from zoneinfo import ZoneInfo
        now = datetime.now(ZoneInfo("Asia/Seoul"))
    except Exception:
        now = datetime.now()
    return now.strftime("%Y%m%d_%H%M%S")


def build_parser() -> argparse.ArgumentParser:
    """One flag per ``Config`` field (``phase_overrides`` aside): booleans
    as ``--flag`` / ``--no-flag``, tuples and optional fields as strings."""
    p = argparse.ArgumentParser("multimodal_neuroimage_tpu_torch")
    for f in dataclasses.fields(Config):
        if f.name == "phase_overrides":
            continue
        name = f"--{f.name}"
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(name, dest=f.name, default=f.default,
                           action=argparse.BooleanOptionalAction)
        elif f.default is None or isinstance(f.default, tuple):
            p.add_argument(name, default=f.default, type=str)
        else:
            p.add_argument(name, default=f.default, type=type(f.default))
    return p


def _parse_tuple(v):
    if isinstance(v, str):
        return tuple(int(x) for x in v.replace(",", " ").split())
    return v


def config_from_args(argv=None) -> Config:
    """The phase's ``Config`` for ``argv``: the flags the user set (those
    that differ from the parser's defaults) beat the phase overlay."""
    parser = build_parser()
    args = vars(parser.parse_args(argv))
    user_set = {k for k, v in args.items() if v != parser.get_default(k)}
    for key in list(args):
        if key.startswith("fusion_") and key.endswith(("depths", "heads")):
            args[key] = _parse_tuple(args[key])
    if isinstance(args.get("mesh_shape"), str):
        args["mesh_shape"] = _parse_tuple(args["mesh_shape"])
    if isinstance(args.get("lr_warmup"), str):
        args["lr_warmup"] = int(args["lr_warmup"])
    base = Config(**args)
    return config_for_phase(base, base.step, user_set=user_set)


def setup_experiment_folder(cfg: Config) -> Config:
    """``<base_path>/experiments/<exp_name>_<target>_<stamp>/``, created, and
    the title ``<exp_name>_<target>``; a named ``experiment_folder`` is
    kept as it is."""
    if cfg.experiment_folder:
        return cfg
    title = f"{cfg.exp_name}_{cfg.target}"
    folder = os.path.join(cfg.base_path, "experiments",
                          f"{title}_{datestamp()}")
    os.makedirs(folder, exist_ok=True)
    return dataclasses.replace(cfg, experiment_folder=folder,
                               experiment_title=title)


def args_logger(cfg: Config) -> None:
    """The resolved config as text and as a pickled dict (reference
    utils.py:153-166)."""
    folder = cfg.experiment_folder
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "argument_documentation.txt"), "w") as f:
        for k, v in sorted(dataclasses.asdict(cfg).items()):
            f.write(f"{k}: {v}\n")
    with open(os.path.join(folder, "arguments.pkl"), "wb") as f:
        pickle.dump(dataclasses.asdict(cfg), f)


def _experiment_meta(folder: str) -> Optional[dict]:
    """The archived arguments of an experiment folder, or None."""
    try:
        with open(os.path.join(folder, "arguments.pkl"), "rb") as f:
            return pickle.load(f)
    except Exception:
        return None


def weight_loader(cfg: Config) -> Optional[str]:
    """The weights a step starts from: ``cfg.model_weights_path``, else the
    best checkpoint of the phase it chains from (``CHAIN_FROM``), else
    None."""
    if cfg.model_weights_path:
        return cfg.model_weights_path
    chain_from = CHAIN_FROM.get(cfg.step)
    if chain_from is None:
        return None
    return _best_checkpoint_for(PHASE_TASKS[chain_from], cfg)


def _candidates(want_task: str, cfg: Config, best_only: bool
                ) -> List[Tuple[bool, bool, bool, float, str]]:
    """(same target, same exp_name, has a BEST file, mtime, newest
    checkpoint) of every experiment folder whose arguments name
    ``want_task``; ``best_only=False`` also takes a folder holding only
    other checkpoints (a rolling ``*_last_epoch.ckpt``)."""
    out = []
    for folder in glob.glob(os.path.join(cfg.base_path, "experiments", "*")):
        meta = _experiment_meta(folder)
        if not meta or meta.get("task") != want_task:
            continue
        ckpts = glob.glob(os.path.join(folder, "*BEST*.ckpt"))
        has_best = bool(ckpts)
        if not ckpts and not best_only:
            ckpts = glob.glob(os.path.join(folder, "*.ckpt"))
        if not ckpts:
            continue
        best = max(ckpts, key=os.path.getmtime)
        out.append((meta.get("target") == cfg.target,
                    meta.get("exp_name") == cfg.exp_name, has_best,
                    os.path.getmtime(best), best))
    return out


def _best_checkpoint_for(want_task: str, cfg: Config,
                         best_only: bool = True) -> Optional[str]:
    """The newest checkpoint of a ``want_task`` experiment, ranked by same
    target first, then same title (``exp_name``), then BEST over
    last-epoch, then mtime. A cross-target candidate is taken with a
    warning, or with ``strict_chaining`` refused with the candidates
    listed."""
    candidates = _candidates(want_task, cfg, best_only)
    if not candidates:
        return None
    same_target, _, has_best, _, path = sorted(candidates)[-1]
    if not same_target:
        if cfg.strict_chaining:
            listing = "\n  ".join(
                f"{'same' if st else 'CROSS'}-target "
                f"{'BEST' if hb else 'last-epoch'}: {p}"
                for st, _, hb, _, p in sorted(candidates, reverse=True))
            raise FileNotFoundError(
                f"--strict_chaining: no '{want_task}' checkpoint trained on "
                f"target '{cfg.target}' found; only cross-target candidates "
                f"exist (check --target for typos, or drop --strict_chaining "
                f"to transfer cross-target):\n  {listing}")
        print(f"[weight_loader] no {want_task} checkpoint for target "
              f"'{cfg.target}'; chaining cross-target from {path}")
    if not has_best:
        print(f"[weight_loader] WARNING: no BEST checkpoint for task "
              f"'{want_task}'; using {os.path.basename(path)} (likely "
              f"last-epoch weights, not validation-selected)")
    return path


def run_phase(cfg: Config, device: str = "cuda") -> dict:
    """One experiment (reference main.py:340-535): the folder, the archived
    arguments, the chained weights, then serving (``predict_only``),
    testing (step 4) or training."""
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    cfg = setup_experiment_folder(cfg)
    args_logger(cfg)
    weights = weight_loader(cfg)
    if weights and not cfg.model_weights_path:
        cfg = dataclasses.replace(cfg, model_weights_path=weights)
    if cfg.use_optuna or cfg.use_best_params_from_optuna:
        raise NotImplementedError(
            "use_optuna / use_best_params_from_optuna: the Optuna harness is "
            "not ported to PyTorch yet (ROADMAP M13)")

    if cfg.predict_only:
        from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
            latest_checkpoint)
        from multimodal_neuroimage_tpu_torch.serve.predictor import (
            run_predict)
        if not cfg.model_weights_path and not latest_checkpoint(
                cfg.experiment_folder):
            found = _best_checkpoint_for(cfg.task, cfg, best_only=False)
            if found is None:
                raise FileNotFoundError(
                    f"--predict_only: no checkpoint in "
                    f"{cfg.experiment_folder!r} and no previous "
                    f"'{cfg.task}' experiment with a BEST checkpoint under "
                    f"{os.path.join(cfg.base_path, 'experiments')!r}; pass "
                    f"--model_weights_path or --experiment_folder")
            print(f"[predict] serving checkpoint {found}")
            cfg = dataclasses.replace(cfg, model_weights_path=found)
        return run_predict(cfg, device=device)

    if cfg.task == "test" or cfg.step == 4:
        return Trainer(cfg, sets=["test"], device=device).testing()
    return Trainer(cfg, sets=["train", "val"], device=device).training()


def main(argv=None, device: Optional[str] = None) -> dict:
    """Parse ``argv`` (``--device`` aside) and run the phase on ``device``
    (the ``--device`` flag, else ``cuda``)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(argv)
    cfg = config_from_args(rest)
    metrics = run_phase(cfg, device=known.device or device or "cuda")
    print("final metrics:", metrics)
    return metrics


if __name__ == "__main__":
    main()
