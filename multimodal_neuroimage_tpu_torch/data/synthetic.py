"""Synthetic cohorts on disk, without pandas (the port's own copy of
multimodal_neuroimage_tpu/data/synthetic.py).

For the same arguments it writes the same ``.npy`` arrays bit for bit and
CSVs that ``pandas.read_csv`` reads as the same frames (floats written as
their shortest round-trip repr), in the layout both packages index
(data/index.py):

  root/data/metadata/ABCD_phenotype_total.csv
  root/multimodal_sub_list.txt
  root/data/fmri_timeseries/sub-<K>/desikankilliany_sub-<K>.npy
  root/data/dti/dti_count_<K>.npy
  root/data/smri_cortical_thickness/smri_cortical_thickness_<K>.npy
  root/data/dti+smri_cortical_thickness/dti_count+smri_cortical_thickness_<K>.npy
  root/data/prs/ABCD_EUR_Multibased_PRScsx_PC1-10resid_scaled.csv
  root/data/fmri_image/masked_image_sub-<K>.nii.gz   (include_fmri_image)
  root/data/hcp/<id>_cortex.npy, HCP_1200_gender.csv, HCP_1200_precise_age.csv

Signals are planted to correlate with the binary target, so a short
training run can show AUROC above 0.5. fMRI series are (20 + T, ROIs) with
T in [350, 361] (the loader drops the first 20 TRs), HCP series (22, T)
with T in [900, 1200]. ``include_fmri_image`` adds each subject's 4-D
NIfTI volume (12 x 14 x 12 voxels, 24 TRs: the reader contract of the
reference's full-resolution volumes, at a small size), whose gzip header
carries the time of writing: its data, not its bytes, equals the JAX
writer's.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_neuroimage_tpu_torch.data.nifti import write_nifti


def _write_csv(path: str, columns: Dict[str, Sequence]) -> None:
    """A header row and one row per index; floats as repr."""
    names = list(columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for row in zip(*(columns[n] for n in names)):
            w.writerow([repr(float(v)) if isinstance(v, (float, np.floating))
                        else v for v in row])


def generate_synthetic_cohort(
    root: str,
    n_subjects: int = 32,
    seed: int = 55555555,
    n_rois: int = 84,
    targets: Optional[List[str]] = None,
    include_fmri_image: bool = False,
    smri_signal: float = 0.5,
    smri_strength_noise: float = 0.0,
) -> str:
    """Create an ABCD-layout cohort under ``root``; returns ``root``."""
    targets = targets or ["sex", "ADHD_label", "age",
                          "nihtbx_totalcomp_uncorrected", "BMI"]
    rng = np.random.default_rng(seed)
    keys = [f"NDARSYN{i:06d}" for i in range(n_subjects)]
    sex = rng.integers(0, 2, n_subjects)
    adhd = rng.integers(0, 2, n_subjects)
    age = rng.normal(120.0, 8.0, n_subjects)
    iq = rng.normal(100.0, 15.0, n_subjects)
    bmi = rng.normal(18.0, 3.0, n_subjects)

    meta_dir = os.path.join(root, "data", "metadata")
    fmri_dir = os.path.join(root, "data", "fmri_timeseries")
    dti_dir = os.path.join(root, "data", "dti")
    smri_dir = os.path.join(root, "data", "smri_cortical_thickness")
    dti_smri_dir = os.path.join(root, "data", "dti+smri_cortical_thickness")
    prs_dir = os.path.join(root, "data", "prs")
    img_dir = os.path.join(root, "data", "fmri_image")
    for d in (meta_dir, fmri_dir, dti_dir, smri_dir, dti_smri_dir, prs_dir,
              img_dir):
        os.makedirs(d, exist_ok=True)

    cols = {"subjectkey": keys}
    known = {"sex": sex.astype(float), "ADHD_label": adhd.astype(float),
             "age": age, "nihtbx_totalcomp_uncorrected": iq, "BMI": bmi}
    for t in targets:
        # the JAX writer's dict.get draws its default for every target
        default = rng.normal(0, 1, n_subjects)
        cols[t] = known.get(t, default)
    _write_csv(os.path.join(meta_dir, "ABCD_phenotype_total.csv"), cols)

    with open(os.path.join(root, "multimodal_sub_list.txt"), "w") as f:
        f.write("\n".join(keys) + "\n")

    _write_csv(os.path.join(
        prs_dir, "ABCD_EUR_Multibased_PRScsx_PC1-10resid_scaled.csv"), {
        "subjectkey": [k[:4] + "_" + k[4:] for k in keys],
        "CPeur2": iq / 100 + rng.normal(0, 0.1, n_subjects),
        "EAeur1": iq / 120 + rng.normal(0, 0.1, n_subjects),
        "IQeur2": iq / 90 + rng.normal(0, 0.1, n_subjects),
    })

    t_axis = np.arange(20 + 361) * 0.8
    for i, key in enumerate(keys):
        srng = np.random.default_rng(seed + 1000 + i)
        T = int(srng.integers(350, 362))
        # fMRI: noise + a sex-dependent slow oscillation in half the ROIs
        sig = srng.normal(0, 1.0, (20 + T, n_rois)).astype(np.float64)
        carrier = np.sin(2 * np.pi * 0.01 * t_axis[:20 + T])[:, None]
        sig[:, : n_rois // 2] += (0.8 if sex[i] else 0.2) * carrier
        sub_dir = os.path.join(fmri_dir, f"sub-{key}")
        os.makedirs(sub_dir, exist_ok=True)
        np.save(os.path.join(sub_dir, f"desikankilliany_sub-{key}.npy"),
                sig.astype(np.float32))

        if include_fmri_image:
            vol = srng.normal(0, 1.0, (12, 14, 12, 24)).astype(np.float32)
            write_nifti(os.path.join(
                img_dir, f"masked_image_sub-{key}.nii.gz"), vol)

        # DTI: symmetric nonneg counts with target-linked block strength
        base = srng.gamma(2.0, 50.0, (n_rois, n_rois))
        base = (base + base.T) / 2
        base[:10, :10] *= (1.6 if sex[i] else 1.0)
        base[10:20, 10:20] *= (1.6 if adhd[i] else 1.0)
        np.fill_diagonal(base, 0.0)
        np.save(os.path.join(dti_dir, f"dti_count_{key}.npy"),
                base.astype(np.float32))

        # sMRI: a class-signed block shift, with optional per-subject
        # strength noise (drawn only when enabled, so the default cohorts
        # keep their per-subject streams)
        smri = srng.normal(2.5, 0.3, (n_rois, n_rois))
        strength = smri_signal * (1 if sex[i] else -1)
        if smri_strength_noise:
            strength += smri_strength_noise * srng.normal()
        smri[:10, :10] += strength
        np.save(os.path.join(smri_dir,
                             f"smri_cortical_thickness_{key}.npy"),
                smri.astype(np.float32))

        # combined: sMRI volume on the diagonal, DTI counts off-diagonal
        comb = base.copy()
        np.fill_diagonal(comb, np.abs(srng.normal(3.0, 0.5, n_rois))
                         + (0.5 if sex[i] else 0.0))
        np.save(os.path.join(
            dti_smri_dir, f"dti_count+smri_cortical_thickness_{key}.npy"),
            comb.astype(np.float32))
    return root


def generate_synthetic_hcp(root: str, n_subjects: int = 16,
                           seed: int = 55555555) -> str:
    """HCP-layout cohort: <id>_cortex.npy (22 ROIs, 900-1200 TRs) and the
    HCP_1200_gender.csv / HCP_1200_precise_age.csv metadata."""
    rng = np.random.default_rng(seed)
    hcp_dir = os.path.join(root, "data", "hcp")
    meta_dir = os.path.join(root, "data", "metadata")
    os.makedirs(hcp_dir, exist_ok=True)
    os.makedirs(meta_dir, exist_ok=True)
    ids = [100000 + i for i in range(n_subjects)]
    gender = rng.integers(0, 2, n_subjects)
    age = rng.normal(28.0, 4.0, n_subjects)
    _write_csv(os.path.join(meta_dir, "HCP_1200_gender.csv"), {
        "Subject": ids, "Gender": ["M" if g else "F" for g in gender]})
    _write_csv(os.path.join(meta_dir, "HCP_1200_precise_age.csv"),
               {"subject": ids, "age": age})
    for i, sid in enumerate(ids):
        srng = np.random.default_rng(seed + 50_000 + i)
        T = int(srng.integers(900, 1201))
        sig = srng.normal(0, 1, (22, T)).astype(np.float32)
        sig[:11] += (0.7 if gender[i] else 0.1) * np.sin(
            2 * np.pi * 0.01 * np.arange(T) * 0.72)[None, :]
        np.save(os.path.join(hcp_dir, f"{sid}_cortex.npy"), sig)
    return root


def synthetic_config(root: str, **overrides):
    """A port ``Config`` pointed at a synthetic cohort directory."""
    from multimodal_neuroimage_tpu_torch.config import Config
    base = dict(
        base_path=root,
        fmri_timeseries_path=os.path.join(root, "data", "fmri_timeseries"),
        dti_path=os.path.join(root, "data", "dti"),
        smri_path=os.path.join(root, "data", "smri_cortical_thickness"),
        dti_smri_path=os.path.join(root, "data", "dti+smri_cortical_thickness"),
        prs_path=os.path.join(root, "data", "prs"),
        hcp_path=os.path.join(root, "data", "hcp"),
        fmri_image_path=os.path.join(root, "data", "fmri_image"),
    )
    base.update(overrides)
    return Config(**base)
