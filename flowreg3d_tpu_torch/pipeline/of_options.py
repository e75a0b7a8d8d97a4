"""OFOptions: the pipeline's user-facing configuration, without pydantic.

Counterpart of ``flowreg3d_tpu/pipeline/of_options.py``: the same fields,
defaults and enums, the same normalisation of alpha (-> 3-tuple), weight
(-> sum 1) and sigma (-> (C, 4)), the same range checks and quality logic
(``min_level >= 0`` makes the preset CUSTOM; ``effective_min_level`` maps
the presets to 0/4/6), ``get_sigma_at``, ``get_weight_at``, ``copy``,
``to_dict`` and ``get_reference_frame`` for an ndarray or an index list
(optionally pre-registered with alpha + 2). A dataclass validated once, at
construction, as the pydantic model is. Not ported yet: TIFF references,
JSON save/load and the MCP schema (they need the io modules).
"""

import copy
import dataclasses
import warnings
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np

from flowreg3d_tpu_torch.io.base import VideoReader3D, VideoWriter3D


class OutputFormat(str, Enum):
    TIFF = "TIFF"
    HDF5 = "HDF5"
    MAT = "MAT"
    MULTIFILE_TIFF = "MULTIFILE_TIFF"
    MULTIFILE_MAT = "MULTIFILE_MAT"
    MULTIFILE_HDF5 = "MULTIFILE_HDF5"
    CAIMAN_HDF5 = "CAIMAN_HDF5"
    BEGONIA = "BEGONIA"
    SUITE2P_TIFF = "SUITE2P_TIFF"
    ARRAY = "ARRAY"


class QualitySetting(str, Enum):
    QUALITY = "quality"
    BALANCED = "balanced"
    FAST = "fast"
    CUSTOM = "custom"


class ChannelNormalization(str, Enum):
    JOINT = "joint"
    SEPARATE = "separate"


class InterpolationMethod(str, Enum):
    NEAREST = "nearest"
    LINEAR = "linear"
    CUBIC = "cubic"


class ConstancyAssumption(str, Enum):
    GRAY = "gray"
    GRADIENT = "gc"


class NamingConvention(str, Enum):
    DEFAULT = "default"
    BATCH = "batch"


_QUALITY_MIN_LEVEL = {
    QualitySetting.QUALITY: 0,
    QualitySetting.BALANCED: 4,
    QualitySetting.FAST: 6,
}

_ENUMS = {
    "output_format": OutputFormat,
    "quality_setting": QualitySetting,
    "channel_normalization": ChannelNormalization,
    "interpolation_method": InterpolationMethod,
    "naming_convention": NamingConvention,
    "constancy_assumption": ConstancyAssumption,
}

# integer field -> its least value
_INT_RANGES = {"levels": 1, "min_level": -1, "update_lag": 1,
               "iterations": 1, "bin_size": 1, "buffer_size": 1,
               "n_references": 1, "min_frames_per_reference": 1, "cc_up": 1}


def _normalize_alpha(v):
    vals = [v] if isinstance(v, (int, float)) else list(v)
    if len(vals) == 1:
        vals = vals * 3
    elif len(vals) == 2:
        # legacy 2D (ax, ay): duplicate the first value for z
        vals = [vals[0], vals[0], vals[1]]
    elif len(vals) != 3:
        raise ValueError("Alpha must be scalar, 2-element, or 3-element")
    vals = [float(a) for a in vals]
    if any(a <= 0 for a in vals):
        raise ValueError("All alpha values must be positive")
    return tuple(vals)


def _normalize_weight(v):
    arr = np.asarray(v, dtype=float)
    if arr.ndim == 1:
        if arr.sum() > 0:
            arr = arr / arr.sum()
        return arr.tolist()
    # spatial weight maps ((C,Z,Y,X) or (Z,Y,X)) stay as ndarrays
    return arr


def _normalize_sigma(v):
    sig = np.asarray(v, dtype=float)
    if sig.ndim == 1:
        if sig.size == 3:  # 2D [sx,sy,st] -> insert sz=1
            sig = np.insert(sig, 2, 1.0)
        elif sig.size != 4:
            raise ValueError("1D sigma must be [sx,sy,sz,st] or [sx,sy,st]")
        return sig.reshape(1, 4).tolist()
    if sig.ndim == 2:
        if sig.shape[1] == 3:
            sig = np.insert(sig, 2, 1.0, axis=1)
        elif sig.shape[1] != 4:
            raise ValueError("2D sigma must be (n_channels, 4)")
        return sig.tolist()
    raise ValueError("Sigma must be [sx,sy,sz,st] or (n_channels, 4)")


@dataclass(repr=False)
class OFOptions:
    """Motion-correction options; the public API contract of the pipeline."""

    # I/O
    input_file: Optional[Union[str, Path, np.ndarray, VideoReader3D,
                               List[str]]] = None
    input_dim_order: str = "TZYX"
    output_path: Path = Path("results")
    output_format: OutputFormat = OutputFormat.MAT
    output_file_name: Optional[str] = None
    channel_idx: Optional[List[int]] = None

    # Flow parameters
    alpha: Union[float, Tuple[float, ...]] = (0.25, 0.25, 0.25)
    weight: Union[List[float], np.ndarray] = field(
        default_factory=lambda: [0.5, 0.5])
    levels: int = 100
    min_level: int = 5
    quality_setting: QualitySetting = QualitySetting.QUALITY
    eta: float = 0.8
    update_lag: int = 5
    iterations: int = 100
    a_smooth: float = 1.0
    a_data: float = 0.45

    # Preprocessing
    sigma: Any = field(default_factory=lambda: [[1.0, 1.0, 1.0, 0.1],
                                                [1.0, 1.0, 1.0, 0.1]])
    bin_size: int = 1
    buffer_size: int = 10

    # Reference
    reference_frames: Union[List[int], str, Path, np.ndarray] = field(
        default_factory=lambda: list(range(50, 500)))
    update_reference: bool = False
    n_references: int = 1
    min_frames_per_reference: int = 20
    preregister_reference: bool = False

    # Processing options
    verbose: bool = False
    save_meta_info: bool = True
    save_w: bool = False
    save_valid_mask: bool = False
    save_valid_idx: bool = False
    output_typename: Optional[str] = "double"
    channel_normalization: ChannelNormalization = ChannelNormalization.JOINT
    interpolation_method: InterpolationMethod = InterpolationMethod.CUBIC
    cc_initialization: bool = False
    cc_hw: Union[int, Tuple[int, int]] = 256
    cc_up: int = 10
    update_initialization_w: bool = True
    naming_convention: NamingConvention = NamingConvention.DEFAULT
    constancy_assumption: ConstancyAssumption = ConstancyAssumption.GRADIENT

    preproc_funct: Optional[Callable] = None

    _video_reader: Optional[VideoReader3D] = field(default=None, init=False)
    _video_writer: Optional[VideoWriter3D] = field(default=None, init=False)
    _quality_setting_old: QualitySetting = field(
        default=QualitySetting.QUALITY, init=False)

    # -- validation ---------------------------------------------------------

    def __post_init__(self):
        for name, enum in _ENUMS.items():
            setattr(self, name, enum(getattr(self, name)))
        for name, lo in _INT_RANGES.items():
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
                raise ValueError(f"{name} must be an int, got {v!r}")
            if v < lo:
                raise ValueError(f"{name} must be >= {lo}, got {v}")
            setattr(self, name, int(v))
        for name, lo, lo_open, hi in (("eta", 0.0, True, 1.0),
                                      ("a_smooth", 0.0, False, None),
                                      ("a_data", 0.0, True, 1.0)):
            v = float(getattr(self, name))
            if v < lo or (lo_open and v == lo) or (hi is not None and v > hi):
                raise ValueError(f"{name} out of range: {v}")
            setattr(self, name, v)
        self.alpha = _normalize_alpha(self.alpha)
        self.weight = _normalize_weight(self.weight)
        self.sigma = _normalize_sigma(self.sigma)
        self.output_path = Path(self.output_path)
        # quality logic: an explicit min_level makes the preset CUSTOM
        if self.quality_setting != QualitySetting.CUSTOM:
            self._quality_setting_old = self.quality_setting
        if self.min_level >= 0:
            self.quality_setting = QualitySetting.CUSTOM
        elif self.quality_setting == QualitySetting.CUSTOM:
            self.quality_setting = self._quality_setting_old

    # -- derived ------------------------------------------------------------

    @property
    def effective_min_level(self) -> int:
        if self.min_level >= 0:
            return self.min_level
        return _QUALITY_MIN_LEVEL.get(self.quality_setting,
                                      max(self.min_level, 0))

    @property
    def constancy(self) -> str:
        return self.constancy_assumption.value

    @constancy.setter
    def constancy(self, value):
        self.constancy_assumption = ConstancyAssumption(value)

    def get_sigma_at(self, i: int) -> np.ndarray:
        sig = np.asarray(self.sigma, dtype=float)
        if sig.ndim == 1:
            return sig
        return sig[i] if i < sig.shape[0] else sig[0]

    def get_weight_at(self, i: int, n_channels: int):
        w = np.asarray(self.weight, dtype=float)
        if w.ndim <= 1:
            if w.size == 1:
                return float(w.reshape(-1)[0])
            if w.size > n_channels:
                w = w[:n_channels]
                w = w / w.sum()
                self.weight = w.tolist()
            if i >= w.size:
                return 1.0 / n_channels
            return float(w[i])
        if i >= w.shape[0]:
            return np.ones(w.shape[1:]) / n_channels
        return w[i]

    def copy(self) -> "OFOptions":
        return copy.deepcopy(self)

    def replace(self, **changes) -> "OFOptions":
        """A deep copy with ``changes`` set, not re-validated (pydantic's
        ``model_copy(update=...)``)."""
        out = self.copy()
        for name, value in changes.items():
            if name not in {f.name for f in dataclasses.fields(self)}:
                raise TypeError(f"OFOptions has no field {name!r}")
            setattr(out, name, value)
        return out

    # -- reader / writer ----------------------------------------------------

    def get_video_reader(self) -> VideoReader3D:
        if self._video_reader is not None:
            return self._video_reader
        from flowreg3d_tpu_torch.io.factory import get_video_file_reader

        self._video_reader = get_video_file_reader(
            self.input_file, buffer_size=self.buffer_size,
            bin_size=self.bin_size, dim_order=self.input_dim_order)
        self.input_file = self._video_reader
        return self._video_reader

    def get_video_writer(self) -> VideoWriter3D:
        if self._video_writer is not None:
            return self._video_writer
        from flowreg3d_tpu_torch.io.factory import get_video_file_writer

        self._video_writer = get_video_file_writer(self.output_file_name,
                                                   self.output_format)
        return self._video_writer

    # -- reference ----------------------------------------------------------

    def get_reference_frame(self, video_reader=None, **compensate_kwargs):
        """Reference volume (Z,Y,X,C): ndarray passthrough, or the mean over
        an index list (optionally pre-registered with alpha + 2;
        ``compensate_kwargs``, e.g. ``device``, go to ``compensate_arr``)."""
        if self.n_references > 1:
            warnings.warn("Multi-reference mode repeats a single reference")
            single = self.replace(n_references=1)
            ref = single.get_reference_frame(video_reader,
                                             **compensate_kwargs)
            return [ref] * self.n_references

        if isinstance(self.reference_frames, np.ndarray):
            return self.reference_frames

        if isinstance(self.reference_frames, (str, Path)):
            raise NotImplementedError(
                f"reference file {self.reference_frames}: file references "
                "are not ported yet (ROADMAP.md Queue 1 item 12)")

        if isinstance(self.reference_frames, list) and video_reader is not None:
            idx = [i for i in self.reference_frames
                   if i < video_reader.binned_count]
            if not idx:
                idx = [0]
            frames = video_reader[idx]  # (T,Z,Y,X,C)
            if frames.ndim == 4:
                return frames
            if frames.shape[0] == 1 or not self.preregister_reference:
                return frames.mean(axis=0)
            return self._preregister_reference(frames, **compensate_kwargs)

        return np.asarray(self.reference_frames)

    def _preregister_reference(self, frames, **compensate_kwargs):
        """Mean -> compensate each frame vs mean with alpha+2 -> mean."""
        from flowreg3d_tpu_torch.pipeline.compensate_arr import compensate_arr

        ref0 = frames.mean(axis=0)
        opts = self.replace(alpha=tuple(a + 2.0 for a in self.alpha),
                            reference_frames=ref0, cc_initialization=False,
                            preregister_reference=False)
        compensated, _ = compensate_arr(frames, ref0, options=opts,
                                        **compensate_kwargs)
        return compensated.mean(axis=0)

    def to_dict(self) -> dict:
        """Solver kwargs for ``get_displacement``."""
        return {
            "alpha": self.alpha,
            "weight": self.weight,
            "levels": self.levels,
            "min_level": self.effective_min_level,
            "eta": self.eta,
            "iterations": self.iterations,
            "update_lag": self.update_lag,
            "a_data": self.a_data,
            "a_smooth": self.a_smooth,
            "const_assumption": self.constancy_assumption.value,
        }

    def __repr__(self) -> str:
        return (f"OFOptions(quality={self.quality_setting.value}, "
                f"alpha={self.alpha}, levels={self.levels}, "
                f"min_level={self.effective_min_level})")

