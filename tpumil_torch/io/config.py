"""One typed configuration for all five pipeline stages (counterpart of
tpumil/io/config.py): the same sections, keys and defaults, and the same
YAML files, so a file written for the JAX package drives the port's
``cli/pipeline`` too:

    pipeline = PipelineConfig.from_yaml("experiment.yaml")
    pipeline.to_yaml("resolved.yaml")   # fully-resolved round-trip

Unknown keys raise immediately (typo safety). The port's sections carry a
``device`` field (``WSITrainConfig``, ``MILBenchConfig``) that the pipeline
sets from ``--device``; it is not a YAML key: ``from_dict`` rejects it and
``to_dict`` leaves it out, so the resolved YAML equals the JAX package's.

PyYAML is imported only to read or write a file.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type, TypeVar

from tpumil_torch.data.tiler import TilerConfig
from tpumil_torch.train.schemes import MILBenchConfig, WSITrainConfig
from tpumil_torch.train.simclr_trainer import SimCLRTrainConfig

T = TypeVar("T")

# fields of the port's sections that are set by the caller, never by YAML
RUNTIME_FIELDS = ("device",)


def _yaml_fields(cls) -> Dict[str, dataclasses.Field]:
    return {f.name: f for f in dataclasses.fields(cls)
            if f.name not in RUNTIME_FIELDS}


def _from_dict(cls: Type[T], data: Dict[str, Any], path: str) -> T:
    fields = _yaml_fields(cls)
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown config keys at {path}: {sorted(unknown)}; "
                         f"valid: {sorted(fields)}")
    return cls(**data)


@dataclasses.dataclass
class EmbedderStageConfig:
    backbone: str = "resnet18"
    norm_layer: str = "instance"
    num_classes: int = 2
    batch_size: int = 128
    num_workers: int = 8
    magnification: str = "single"
    weights: Optional[str] = None
    weights_high: Optional[str] = None
    weights_low: Optional[str] = None
    tree_fusion: str = "cat"
    patch_size: int = 224
    # bf16 | f32 | f32h | f32x, as cli/compute_feats --precision: bf16
    # activations, or true f32 (the port's one f32 tier) for the other three
    precision: str = "f32"
    # the plain 7x7/s2 stem or its space-to-depth rewrite (the same
    # features); mirror of cli/compute_feats --space_to_depth
    space_to_depth: bool = True
    # split each patch batch of the feats and maps stages over N devices,
    # one process each (0 = one device)
    data_parallel: int = 0


@dataclasses.dataclass
class InferenceStageConfig:
    thresholds: Optional[list] = None
    class_names: Optional[list] = None
    batch_size: int = 64
    num_workers: int = 8
    # None = follow the tiler's output format in the pipeline
    # (standalone attention_map defaults to 'jpg' like the reference)
    patch_ext: Optional[str] = None
    export_scores: bool = False
    average: bool = False


@dataclasses.dataclass
class PipelineConfig:
    """End-to-end experiment description."""

    dataset: str = "TCGA-lung"
    wsi_root: str = "WSI"
    datasets_root: str = "datasets"
    magnifications: tuple = (0,)
    tiler: TilerConfig = dataclasses.field(default_factory=TilerConfig)
    simclr: SimCLRTrainConfig = dataclasses.field(default_factory=SimCLRTrainConfig)
    embedder: EmbedderStageConfig = dataclasses.field(default_factory=EmbedderStageConfig)
    train: WSITrainConfig = dataclasses.field(default_factory=WSITrainConfig)
    mil_bench: Optional[MILBenchConfig] = None
    inference: InferenceStageConfig = dataclasses.field(default_factory=InferenceStageConfig)

    _SECTIONS = {
        "tiler": TilerConfig,
        "simclr": SimCLRTrainConfig,
        "embedder": EmbedderStageConfig,
        "train": WSITrainConfig,
        "mil_bench": MILBenchConfig,
        "inference": InferenceStageConfig,
    }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "PipelineConfig":
        data = dict(data)
        kwargs: Dict[str, Any] = {}
        for name, sub_cls in cls._SECTIONS.items():
            if name in data:
                sub = data.pop(name)
                kwargs[name] = (None if sub is None
                                else _from_dict(sub_cls, sub, name))
        scalar_fields = {f.name for f in dataclasses.fields(cls)
                         if f.name not in cls._SECTIONS}
        unknown = set(data) - scalar_fields
        if unknown:
            raise ValueError(f"unknown top-level config keys: {sorted(unknown)}")
        if "magnifications" in data:
            data["magnifications"] = tuple(data["magnifications"])
        kwargs.update(data)
        return cls(**kwargs)

    @classmethod
    def from_yaml(cls, path: str) -> "PipelineConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def to_dict(self) -> Dict[str, Any]:
        def clean(obj):
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                return {name: clean(getattr(obj, name))
                        for name in _yaml_fields(type(obj))}
            if isinstance(obj, tuple):
                return list(obj)
            return obj

        return {f.name: clean(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    def to_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)
