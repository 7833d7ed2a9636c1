"""Experiment config: the same frozen dataclasses, fields and JSON as
``mcmda_tpu/config.py``, so one ``configs/*.json`` drives both packages.

One difference: ``SegmenterConfig.compute_dtype`` is held as a dtype *name*
("float32" or "bfloat16"); ``torch_dtype`` maps it to a torch dtype at use.
Fields of paths not ported yet (adaptation, the critic, data parallelism)
are kept so that every config file parses identically.

The kernel switches keep the JAX package's strings.  On a CUDA tensor,
``data.warp="pallas"`` selects the hand-written warp kernel and
``segmenter.train_fused="pallas"`` the conv + BN-moments kernel;
``"xla"`` and ``"none"`` select their plain PyTorch versions.  On a CPU
tensor every path runs the plain versions.  ``run.use_pallas`` likewise
selects the fused eval conv (``predict``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """Map a compute-dtype name to the torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"compute_dtype {name!r} not in {sorted(_DTYPES)}") \
            from None


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage of the dilated-residual segmenter."""

    name: str
    features: int
    stride: int = 1
    dilation: int = 1
    blocks: int = 2


# widths 16 -> 512, x8 total stride, dilated tail at 1/8 resolution
DEFAULT_STAGES: Tuple[StageSpec, ...] = (
    StageSpec("stem", 16, stride=1, dilation=1, blocks=1),
    StageSpec("rm1", 32, stride=2, dilation=1, blocks=2),
    StageSpec("rm2", 64, stride=2, dilation=1, blocks=2),
    StageSpec("rm3", 128, stride=2, dilation=1, blocks=2),
    StageSpec("rm4", 256, stride=1, dilation=2, blocks=2),
    StageSpec("rm5", 512, stride=1, dilation=2, blocks=2),
    StageSpec("rm6", 512, stride=1, dilation=4, blocks=2),
)


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    """2D dilated-residual FCN: 256x256x3 in, 5-class softmax out."""

    in_channels: int = 3
    num_classes: int = 5
    stages: Tuple[StageSpec, ...] = DEFAULT_STAGES
    bn_momentum: float = 0.99
    bn_eps: float = 1e-5
    # conv/matmul input dtype name; params and BN stats stay f32
    compute_dtype: str = "float32"
    # layout of the thin high-res stages in the JAX package ("s2d", "s2d2",
    # "nhwc"); all three compute the same math, so the port accepts the
    # field and ignores it
    thin_layout: str = "s2d2"
    # "pallas": train-mode conv + BN moments of the wide tail through the
    # fused kernel; "none": plain conv + BN
    train_fused: str = "none"

    @property
    def total_stride(self) -> int:
        s = 1
        for st in self.stages:
            s *= st.stride
        return s


@dataclasses.dataclass(frozen=True)
class CriticConfig:
    """Feature-space PatchGAN domain critic over multi-level taps."""

    taps: Tuple[str, ...] = ("rm4", "rm6")
    compress_features: int = 64
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    strides: Tuple[int, ...] = (2, 2, 2, 1)
    lrelu_slope: float = 0.2
    mode: str = "concat"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Slice geometry, batching, augmentation."""

    slice_size: int = 256
    context_slices: int = 3  # adjacent slices stacked as channels
    num_classes: int = 5
    batch_size: int = 8
    flip: bool = True
    rotate_degrees: float = 15.0
    zoom_range: Tuple[float, float] = (0.9, 1.1)
    shift_pixels: float = 10.0
    # augmentation warp: "pallas" = the warp kernel, "xla" = plain
    warp: str = "xla"


@dataclasses.dataclass(frozen=True)
class SourceTrainConfig:
    """Supervised source-segmenter training."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    steps: int = 20000
    xent_weight: float = 1.0
    dice_weight: float = 1.0
    class_weights: Tuple[float, ...] | None = None
    lr_schedule: str = "constant"


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """PnP-AdaNet adversarial adaptation.  ``plug_depth`` names the last
    stage of the domain adaptation module (DAM); serving reads it to split
    the adapted weights from the frozen higher layers."""

    plug_depth: str = "rm3"
    k_d: int = 1
    k_g: int = 1
    lr_d: float = 1e-4
    lr_g: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.999
    steps: int = 10000
    pretrain_steps: int = 0
    gan_loss: str = "nonsat"
    label_smooth: float = 0.0
    r1_gamma: float = 0.0
    d_acc_cap: float = 1.0
    lr_schedule: str = "constant"
    hlm_bn: str = "batch"
    share_tgt_fwd: bool = True
    batch_critic: bool = False
    # per-step EMA decay of the averaged DAM weights (0 disables); serving
    # reads it to pick the weight variant under ``--weights auto``
    dam_ema: float = 0.0
    ema_gate: float = 0.0
    ema_gate_smooth: float = 0.9986
    src_feats_bf16: bool = False
    tgt_feats_bf16: bool = False
    select_signal: str = "class_ratio"
    select_warmup: int = 500
    select_every: int = 250
    select_policy: str = "cr_ent"
    select_topk: int = 16
    select_smooth_span: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    sync_bn: bool = True


@dataclasses.dataclass(frozen=True)
class RunConfig:
    seed: int = 0
    log_every: int = 50
    ckpt_every: int = 1000
    ckpt_dir: str = "checkpoints"
    metrics_path: str = "metrics.jsonl"
    # serving: run the fused conv+BN+activation path (the hand-written
    # kernel on a GPU) instead of the plain eval forward
    use_pallas: bool = False
    donate: bool = True
    debug_nans: bool = False
    # 3D post-processing of predictions: "cc" (largest connected component
    # per structure) or "none"
    eval_postprocess: str = "none"
    # test-time augmentation at serving: "flip" or "none"
    eval_tta: str = "none"
    # serving-only bf16 compute (``eval_view``); training dtype untouched
    eval_bf16: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Bundle of everything; JSON round-trippable."""

    segmenter: SegmenterConfig = SegmenterConfig()
    critic: CriticConfig = CriticConfig()
    data: DataConfig = DataConfig()
    source: SourceTrainConfig = SourceTrainConfig()
    adapt: AdaptConfig = AdaptConfig()
    parallel: ParallelConfig = ParallelConfig()
    run: RunConfig = RunConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "ExperimentConfig":
        raw = json.loads(text)
        return ExperimentConfig(
            segmenter=_seg_from(raw.get("segmenter", {})),
            critic=_mk(CriticConfig, raw.get("critic", {})),
            data=_mk(DataConfig, raw.get("data", {})),
            source=_mk(SourceTrainConfig, raw.get("source", {})),
            adapt=_mk(AdaptConfig, raw.get("adapt", {})),
            parallel=_mk(ParallelConfig, raw.get("parallel", {})),
            run=_mk(RunConfig, raw.get("run", {})),
        )


def _tupled(v):
    return tuple(v) if isinstance(v, list) else v


def _mk(cls, d):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _tupled(v) for k, v in d.items() if k in fields})


def _seg_from(d):
    d = dict(d)
    if "stages" in d:
        d["stages"] = tuple(_mk(StageSpec, s) for s in d["stages"])
    if "compute_dtype" in d:
        torch_dtype(d["compute_dtype"])  # validate the name
    return _mk(SegmenterConfig, d)


def eval_view(cfg: ExperimentConfig) -> ExperimentConfig:
    """The config the serving forward is built with: applies
    ``run.eval_bf16`` without touching the training dtype."""
    if not cfg.run.eval_bf16 or cfg.segmenter.compute_dtype == "bfloat16":
        return cfg
    return dataclasses.replace(
        cfg, segmenter=dataclasses.replace(cfg.segmenter,
                                           compute_dtype="bfloat16"))


def load_config(path: str | None, overrides=()) -> ExperimentConfig:
    """Read a config JSON (or the defaults) and apply ``--set a.b=v``
    overrides."""
    if path:
        with open(path) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = ExperimentConfig()
    for ov in overrides or ():
        key, _, val = ov.partition("=")
        cfg = apply_override(cfg, key.split("."), val)
    return cfg


def apply_override(obj, keys, val):
    """Replace the field at the dotted path ``keys`` with ``val``, parsed as
    JSON when it parses (bare strings such as ``plug_depth=rm2`` stay
    strings; lists become tuples)."""
    if len(keys) == 1:
        try:
            parsed = json.loads(val)
        except ValueError:
            parsed = val
        if isinstance(parsed, list):
            parsed = tuple(parsed)
        if keys[0] == "compute_dtype":
            torch_dtype(parsed)
        return dataclasses.replace(obj, **{keys[0]: parsed})
    sub = getattr(obj, keys[0])
    return dataclasses.replace(
        obj, **{keys[0]: apply_override(sub, keys[1:], val)})
