"""Typed configuration mirroring the reference's YAML contracts (a copy of
``cerberus_tpu/config.py``; PyYAML is imported only where YAML is read).

``settings.yml`` / ``models/paramset.yml`` schema: ``loader_kwargs``,
``optimizer_kwargs``, ``loss_kwargs``, ``dataset_kwargs`` (incl.
``req_target_code``), ``model_kwargs`` (incl. ``decoder_kwargs``) — see
reference ``models/paramset.yml:1-59`` and ``run_infer_tile.py:46-49``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

# Default task list used by both reference CLIs (run_infer_tile.py:51).
DEFAULT_TARGET_LIST = ["gland", "lumen", "nuclei", "patch-class"]

# Default decoder layout of the published multi-task checkpoint
# (models/paramset.yml:45-59). Dict order defines the canvas channel order.
DEFAULT_DECODER_KWARGS = {
    "Lumen": {"INST": 3},
    "Gland": {"INST": 3},
    "Nuclei": {"INST": 3},
    "Nuclei#TYPE": {"TYPE": 7},
    "Gland#TYPE": {"TYPE": 3},
    "Patch-Class": {"OUT": 9},
}

DEFAULT_TARGET_CODE = {
    "Lumen-INST": "IP-ERODED-CONTOUR-3",
    "Gland-INST": "IP-ERODED-CONTOUR-11",
    "Nuclei-INST": "IP-ERODED-CONTOUR-3",
    "Nuclei-TYPE": "TP",
    "Gland-TYPE": "TP",
    "Patch-Class": "PC",
}

ALL_TASKS = ["Lumen", "Gland", "Nuclei", "Nuclei#TYPE", "Gland#TYPE", "Patch-Class"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyper-parameters (frozen, hashable)."""

    encoder_backbone_name: str = "resnet34"
    # ((decoder_name, ((head_name, nr_ch), ...)), ...)
    decoder_info: Tuple[Tuple[str, Tuple[Tuple[str, int], ...]], ...] = ()
    considered_tasks: Tuple[str, ...] = ()
    subtype_gland: bool = False
    subtype_nuclei: bool = False

    @classmethod
    def from_kwargs(cls, model_kwargs: Mapping[str, Any]) -> "ModelConfig":
        decoder_kwargs = model_kwargs.get("decoder_kwargs") or DEFAULT_DECODER_KWARGS
        considered = model_kwargs.get("considered_tasks") or list(decoder_kwargs)
        return cls(
            encoder_backbone_name=model_kwargs.get(
                "encoder_backbone_name", "resnet34"
            ),
            decoder_info=tuple(
                (name, tuple(heads.items())) for name, heads in decoder_kwargs.items()
            ),
            considered_tasks=tuple(considered),
            subtype_gland=bool(model_kwargs.get("subtype_gland", False)),
            subtype_nuclei=bool(model_kwargs.get("subtype_nuclei", False)),
        )

    @property
    def decoder_kwargs(self) -> Dict[str, Dict[str, int]]:
        return {name: dict(heads) for name, heads in self.decoder_info}

    @property
    def active_decoder_kwargs(self) -> Dict[str, Dict[str, int]]:
        """decoder_kwargs restricted to considered tasks — the canvas
        channel layout for partial-task checkpoints."""
        return {name: dict(heads) for name, heads in self.decoder_info
                if name in self.considered_tasks}

    def active_decoders(self) -> List[str]:
        return [name for name, _ in self.decoder_info if name in self.considered_tasks]


@dataclasses.dataclass
class ParamSet:
    """Full parsed settings.yml."""

    loader_kwargs: Dict[str, Any]
    optimizer_kwargs: Dict[str, Any]
    loss_kwargs: Dict[str, Any]
    dataset_kwargs: Dict[str, Any]
    model_kwargs: Dict[str, Any]

    @classmethod
    def from_yaml(cls, path: str) -> "ParamSet":
        import yaml

        with open(path) as fptr:
            raw = yaml.safe_load(fptr)
        return cls(
            loader_kwargs=raw.get("loader_kwargs", {}),
            optimizer_kwargs=raw.get("optimizer_kwargs", {}),
            loss_kwargs=raw.get("loss_kwargs", {}),
            dataset_kwargs=raw.get("dataset_kwargs", {}),
            model_kwargs=raw.get("model_kwargs", {}),
        )

    @property
    def model_config(self) -> ModelConfig:
        return ModelConfig.from_kwargs(self.model_kwargs)

    @property
    def req_target_code(self) -> Dict[str, str]:
        return self.dataset_kwargs.get("req_target_code", dict(DEFAULT_TARGET_CODE))


def load_settings(model_dir: str) -> ParamSet:
    """Load ``<model_dir>/settings.yml`` (reference run_infer_tile.py:46-49)."""
    return ParamSet.from_yaml("%s/settings.yml" % model_dir)
