"""Subject index of an on-disk cohort: metadata scan, cohort intersection,
target encoding (the port's own copy of multimodal_neuroimage_tpu/data/
index.py, on ``csv`` and numpy instead of pandas).

The file layout is the JAX package's, so a cohort prepared for either
package (or for the reference) is read by both:

* fMRI: ``<fmri_dir>/sub-<KEY>/desikankilliany_sub-<KEY>.npy`` (84 ROIs),
  ``harvard_oxford_sub-<KEY>.npy`` for 48;
* DTI: ``<dti_dir>/dti_count_<KEY>.npy``;
* sMRI: ``<smri_dir>/smri_<kind>_<KEY>.npy``, kind from the directory name;
* struct (phase 6's pair): both of the above;
* DTI+sMRI: ``<dti_smri_dir>/dti_count+smri_<kind>_<KEY>.npy``, kind from
  the directory name;
* multimodal, multimodal_prs: the fMRI series and the DTI+sMRI matrix;
  multimodal_prs adds the three polygenic scores ``CPeur2 EAeur1 IQeur2`` of
  ``<prs_dir>/ABCD_EUR_Multibased_PRScsx_PC1-10resid_scaled.csv`` (its
  ``subjectkey`` without ``_``), z-scored over the subjects the metadata and
  the PRS table share, in each record's ``prs``;
* HCP: ``<hcp_dir>/<SUBJECT>_cortex.npy``.

Where the JAX index leans on pandas, this copy reproduces what pandas
does: ``read_csv``'s default NA tokens (``NA_TOKENS``) and its integer /
float / string column types, ``dropna`` over the key and target columns,
``Series.std()`` with ddof 1, the first row of a repeated key
(``.iloc[0]``), ``astype(int)`` subject keys on HCP, the rows of an inner
``merge`` (one a pair of matching rows) and the last of a key's rows in a
dict built from them.

Only the datasets whose models the port runs are indexed (``PORTED``):
``fMRI_image`` raises, naming the ROADMAP item that ports it
(``WAITING``).
"""

from __future__ import annotations

import csv
import math
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PORTED = ("hcp", "fMRI_timeseries", "multimodal", "multimodal_prs", "DTI",
          "sMRI", "struct", "DTI+sMRI")
MULTIMODAL = ("multimodal", "multimodal_prs")
# the datasets still to load: what ports each, and its ROADMAP item
WAITING = {"fMRI_image": ("its NIfTI reader (data/nifti.py) and the model "
                          "that reads it", "N6")}
PRS_FILE = "ABCD_EUR_Multibased_PRScsx_PC1-10resid_scaled.csv"
PRS_COLUMNS = ("CPeur2", "EAeur1", "IQeur2")

# pandas.read_csv's default NA tokens (pandas._libs.parsers.STR_NA_VALUES)
NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT = re.compile(r"[+-]?\d+")


@dataclass
class SubjectRecord:
    idx: int
    subject: str
    paths: Dict[str, str]
    target: float
    prs: Optional[np.ndarray] = None


def check_dataset(dataset_name: str) -> None:
    """Raise for a dataset the port does not load."""
    if dataset_name in WAITING:
        what, item = WAITING[dataset_name]
        raise NotImplementedError(
            f"dataset {dataset_name!r} is not loaded by the port yet: it "
            f"waits for {what} (ROADMAP {item})")
    if dataset_name not in PORTED:
        raise ValueError(f"unknown dataset {dataset_name!r}")


def _number(token: str):
    """The float of a numeric token, else None (no underscores: Python's
    float() takes them, pandas does not)."""
    if "_" in token:
        return None
    try:
        return float(token)
    except ValueError:
        return None


def _typed(tokens: Sequence[Optional[str]]) -> List:
    """A column as pandas types it: int when every token is an integer and
    none is missing, float (missing -> nan) when every present token is a
    number, else strings (missing -> None)."""
    present = [t for t in tokens if t is not None]
    if present and len(present) == len(tokens) and all(
            _INT.fullmatch(t) for t in present):
        return [int(t) for t in tokens]
    nums = [_number(t) for t in present]
    if all(v is not None for v in nums):
        return [math.nan if t is None else float(t) for t in tokens]
    return list(tokens)


def _read_csv(path: str) -> Dict[str, List]:
    """{column: typed values} of a CSV with a header row, as
    ``pandas.read_csv`` reads it with its defaults (blank lines skipped, a
    short row filled with missing values). A repeated column name keeps its
    first column."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    cols: Dict[str, List] = {}
    for j, name in enumerate(header):
        if name in cols:
            continue
        cols[name] = _typed([
            None if j >= len(r) or r[j] in NA_TOKENS else r[j] for r in body])
    return cols


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _as_str(v) -> str:
    """``Series.astype(str)`` of one value."""
    return "nan" if v is None else str(v)


def _std(values: Sequence[float]) -> float:
    """``Series.std()``: ddof 1, nan below two values."""
    v = np.asarray(values, np.float64)
    return float(v.std(ddof=1)) if len(v) > 1 else math.nan


def _smri_kind(path: str) -> str:
    """sMRI measure resolved from a directory name."""
    for kind in ("area", "cortical_thickness", "meancurv", "volume"):
        if kind in path:
            return kind
    return "cortical_thickness"


def resolve_paths(dataset_name: str, subject: str, cfg) -> Dict[str, str]:
    check_dataset(dataset_name)
    if dataset_name == "hcp":
        return {"fmri": os.path.join(cfg.hcp_path, f"{subject}_cortex.npy")}
    paths: Dict[str, str] = {}
    if dataset_name in ("fMRI_timeseries",) + MULTIMODAL:
        atlas = ("desikankilliany" if cfg.intermediate_vec == 84
                 else "harvard_oxford")
        paths["fmri"] = os.path.join(cfg.fmri_timeseries_path,
                                     f"sub-{subject}",
                                     f"{atlas}_sub-{subject}.npy")
    if dataset_name in ("sMRI", "struct"):
        kind = _smri_kind(cfg.smri_path)
        paths["smri"] = os.path.join(cfg.smri_path,
                                     f"smri_{kind}_{subject}.npy")
    if dataset_name in ("DTI", "struct"):
        paths["dti"] = os.path.join(cfg.dti_path, f"dti_count_{subject}.npy")
    if dataset_name in ("DTI+sMRI",) + MULTIMODAL:
        kind = _smri_kind(cfg.dti_smri_path)
        paths["struct"] = os.path.join(
            cfg.dti_smri_path, f"dti_count+smri_{kind}_{subject}.npy")
    return paths


def build_hcp_index(cfg, require_target: bool = True
                    ) -> List[SubjectRecord]:
    """HCP cohort: sex from HCP_1200_gender.csv (Subject / Gender, M -> 1),
    age from HCP_1200_precise_age.csv (subject / age, z-scored over every
    row of the file); the subjects are the ``<id>_cortex.npy`` files in
    ``cfg.hcp_path``. A subject without a (non-missing) value is left out,
    or given target 0.0 when ``require_target`` is False."""
    meta_dir = os.path.join(cfg.base_path, "data", "metadata")
    if cfg.target == "age":
        key_col, val_col, name = "subject", "age", "HCP_1200_precise_age.csv"
    elif cfg.target == "sex":
        key_col, val_col, name = "Subject", "Gender", "HCP_1200_gender.csv"
    else:
        raise ValueError(f"HCP supports targets 'sex'/'age', got {cfg.target}")
    meta = _read_csv(cfg.metadata_csv or os.path.join(meta_dir, name))
    lookup: Dict[int, object] = {}
    for k, v in zip(meta[key_col], meta[val_col]):
        lookup.setdefault(int(k), v)             # first row of a repeat
    if cfg.target == "age":
        ages = [float(v) for v in meta[val_col] if not _missing(v)]
        mean = float(np.mean(ages)) if ages else math.nan
        std = _std(ages)

    records: List[SubjectRecord] = []
    for fname in sorted(os.listdir(cfg.hcp_path)):
        if not fname.endswith("_cortex.npy"):
            continue
        subject = fname.split("_")[0]
        val = lookup.get(int(subject))
        if _missing(val):
            if require_target:
                continue
            target = 0.0       # unlabeled serving subject, never read
        elif cfg.target == "age":
            target = (float(val) - mean) / std
        else:
            target = 1.0 if str(val) == "M" else 0.0
        records.append(SubjectRecord(
            idx=len(records), subject=subject,
            paths=resolve_paths("hcp", subject, cfg), target=target))
    return records


def _labeled(meta: Dict[str, List], key_col: str, target: str,
             require_target: bool) -> Tuple[List[Tuple[str, float]], List]:
    """(rows kept as (key string, target value), target values of the
    genuinely labeled rows): ``dropna`` over key and target, or with
    ``require_target`` False every row, a missing target filled with 0.0."""
    keys = meta[key_col]
    vals = meta.get(target, [0.0] * len(keys))
    has_target = target in meta
    labeled = [v for k, v in zip(keys, vals)
               if has_target and not _missing(k) and not _missing(v)]
    if require_target:
        rows = [(_as_str(k), v) for k, v in zip(keys, vals)
                if not _missing(k) and not _missing(v)]
    else:
        rows = [(_as_str(k), 0.0 if _missing(v) else v)
                for k, v in zip(keys, vals)]
    return rows, labeled


def build_subject_index(cfg, require_target: bool = True
                        ) -> List[SubjectRecord]:
    """Scan the metadata, intersect with ``multimodal_sub_list.txt`` when it
    exists, encode the targets. Regression targets are z-scored with the
    mean and std of every labeled metadata row (before the intersection).
    ``require_target=False`` (serving) keeps a subject whose target is
    missing, with a dummy 0.0 target that the predict forward never
    reads."""
    check_dataset(cfg.dataset_name)
    if cfg.dataset_name == "hcp":
        return build_hcp_index(cfg, require_target=require_target)
    meta_csv = cfg.metadata_csv or os.path.join(
        cfg.base_path, "data", "metadata", "ABCD_phenotype_total.csv")
    meta = _read_csv(meta_csv)
    key_col = "subjectkey" if "subjectkey" in meta else next(iter(meta))
    if cfg.target not in meta and require_target:
        raise KeyError(f"target column {cfg.target!r} not in {meta_csv}")
    rows, labeled = _labeled(meta, key_col, cfg.target, require_target)

    subjects = {k for k, _ in rows}
    sub_list = cfg.subject_list_path or os.path.join(cfg.base_path,
                                                     "multimodal_sub_list.txt")
    if os.path.exists(sub_list):
        with open(sub_list) as f:
            subjects &= set(f.read().splitlines())

    if cfg.fine_tune_task == "regression":
        cont_mean = float(np.mean(labeled)) if labeled else math.nan
        cont_std = _std(labeled)
        if not np.isfinite(cont_std) or cont_std == 0.0:
            cont_mean, cont_std = 0.0, 1.0   # unlabeled serving cohort

    prs_table = None
    if cfg.dataset_name == "multimodal_prs":
        prs_table = prs_scores(cfg, [k for k, _ in rows])
        subjects &= set(prs_table)

    lookup: Dict[str, object] = {}
    for k, v in rows:
        lookup.setdefault(k, v)                  # first row of a repeat
    records: List[SubjectRecord] = []
    for i, subject in enumerate(sorted(subjects)):
        raw_t = float(lookup[subject])
        target = ((raw_t - cont_mean) / cont_std
                  if cfg.fine_tune_task == "regression" else raw_t)
        records.append(SubjectRecord(
            idx=i, subject=subject,
            paths=resolve_paths(cfg.dataset_name, subject, cfg),
            target=target,
            prs=None if prs_table is None else prs_table[subject]))
    return records


def prs_scores(cfg, keys: Sequence[str]) -> Dict[str, np.ndarray]:
    """{subject: its three z-scored PRS, float32} over the inner join of the
    metadata rows' ``keys`` with the PRS table (JAX index.py:173-189): the
    table's ``subjectkey`` as a string without ``_``, its rows with a
    missing score dropped; each score z-scored with the mean and std (ddof
    1) of the joined rows, a key repeated on both sides counting once a
    pair; a subject takes its last table row."""
    table = _read_csv(os.path.join(cfg.prs_path, PRS_FILE))
    prs_rows: Dict[str, List[Tuple[float, ...]]] = {}
    for i, key in enumerate(table["subjectkey"]):
        vals = tuple(table[c][i] for c in PRS_COLUMNS)
        if any(_missing(v) for v in vals):
            continue
        prs_rows.setdefault(_as_str(key).replace("_", ""), []).append(
            tuple(float(v) for v in vals))
    counts: Dict[str, int] = {}
    for k in keys:
        counts[k] = counts.get(k, 0) + 1
    joined = [row for k, n in counts.items() for row in prs_rows.get(k, ())
              for _ in range(n)]
    cols = np.asarray(joined, np.float64).reshape(-1, len(PRS_COLUMNS))
    mean = cols.mean(axis=0) if len(cols) else np.full(3, math.nan)
    std = np.asarray([_std(cols[:, j]) for j in range(len(PRS_COLUMNS))])
    return {k: ((np.asarray(prs_rows[k][-1]) - mean) / std).astype(
        np.float32) for k in counts if k in prs_rows}
