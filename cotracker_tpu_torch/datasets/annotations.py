"""Typed hydration of Dynamic Replica's JSON frame annotations (port of
cotracker_tpu/datasets/annotations.py, pure stdlib; the reference's
dataclass_utils loader and its DynamicReplicaFrameAnnotation schema).

`frame_annotations_{split}.jgz` is a gzipped JSON list of frame records.
`load_frame_annotations` hydrates it into typed dataclasses:
  * unknown JSON keys raise (the reference loader is as strict);
  * missing required fields raise;
  * Optional / List / Tuple / Dict annotations recurse;
  * numeric leaves coerce (JSON has no int/float distinction).
Every schema violation is an `AnnotationError`.

The reference declares `trajectories: Optional[str]`, but the shipped
data stores {"path": ...}, which the reference then indexes as
`fa["trajectories"]["path"]`: it is typed here as the dict it is.
"""

import dataclasses
import gzip
import json
import typing
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ImageAnnotation:
    # path to the jpg file, relative to the dataset root
    path: str
    # (H, W)
    size: Tuple[int, int]


@dataclass
class DynamicReplicaFrameAnnotation:
    """One frame's annotation record (reference dr_dataset.py:29-44)."""

    # joins frames into sequences
    sequence_name: str
    # 0-based continuous frame number within the sequence
    frame_number: int
    # seconds from video start
    frame_timestamp: float
    image: ImageAnnotation
    meta: Optional[Dict[str, Any]] = None
    camera_name: Optional[str] = None
    # {"path": <relative .pth path>} holding img / traj_2d / verts_inds_vis
    trajectories: Optional[Dict[str, Any]] = None


class AnnotationError(ValueError):
    """Raised when a JSON annotation does not match the declared schema."""


def hydrate(value, typeannot):
    """Recursively convert a parsed-JSON value into `typeannot`.

    Supports dataclasses, Optional/Union[None, X], List/Tuple/Dict generics,
    and primitive leaves (int/float coerce; everything else must already
    match). Raises AnnotationError on schema violations.
    """
    origin = typing.get_origin(typeannot)
    args = typing.get_args(typeannot)

    # Optional[X] / Union[..., None]
    if origin is typing.Union:
        if value is None:
            if type(None) in args:
                return None
            raise AnnotationError(f"None not allowed for {typeannot}")
        inner = [a for a in args if a is not type(None)]
        if len(inner) != 1:
            raise AnnotationError(f"unsupported Union {typeannot}")
        return hydrate(value, inner[0])

    if dataclasses.is_dataclass(typeannot):
        if not isinstance(value, dict):
            raise AnnotationError(
                f"{typeannot.__name__} needs an object, got {type(value).__name__}"
            )
        fields = {f.name: f for f in dataclasses.fields(typeannot)}
        unknown = set(value) - set(fields)
        if unknown:
            raise AnnotationError(
                f"unknown key(s) {sorted(unknown)} for {typeannot.__name__}"
            )
        kwargs = {}
        for name, f in fields.items():
            if name in value:
                kwargs[name] = hydrate(value[name], f.type)
            elif (
                f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING
            ):
                raise AnnotationError(
                    f"missing required field '{name}' of {typeannot.__name__}"
                )
        return typeannot(**kwargs)

    if origin in (list, typing.List):
        if not isinstance(value, list):
            raise AnnotationError(f"expected list, got {type(value).__name__}")
        elem = args[0] if args else Any
        return [hydrate(v, elem) for v in value]

    if origin in (tuple, typing.Tuple):
        if not isinstance(value, (list, tuple)):
            raise AnnotationError(f"expected tuple, got {type(value).__name__}")
        if args and args[-1] is not Ellipsis:
            if len(value) != len(args):
                raise AnnotationError(
                    f"expected {len(args)}-tuple, got length {len(value)}"
                )
            return tuple(hydrate(v, a) for v, a in zip(value, args))
        elem = args[0] if args else Any
        return tuple(hydrate(v, elem) for v in value)

    if origin in (dict, typing.Dict):
        if not isinstance(value, dict):
            raise AnnotationError(f"expected object, got {type(value).__name__}")
        kt = args[0] if args else Any
        vt = args[1] if args else Any
        return {hydrate(k, kt): hydrate(v, vt) for k, v in value.items()}

    if typeannot is Any:
        return value
    if typeannot is float:
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            raise AnnotationError(f"expected float, got {type(value).__name__}")
        return float(value)
    if typeannot is int:
        if not isinstance(value, int) or isinstance(value, bool):
            raise AnnotationError(f"expected int, got {type(value).__name__}")
        return value
    if typeannot in (str, bool):
        if not isinstance(value, typeannot):
            raise AnnotationError(
                f"expected {typeannot.__name__}, got {type(value).__name__}"
            )
        return value
    raise AnnotationError(f"unsupported annotation {typeannot!r}")


def load_frame_annotations(path: str) -> List[DynamicReplicaFrameAnnotation]:
    """Load + validate frame_annotations_{split}.jgz (gzipped JSON list)."""
    with gzip.open(path, "rt", encoding="utf8") as f:
        raw = json.load(f)
    if not isinstance(raw, list):
        raise AnnotationError("annotation file must hold a JSON list")
    return [hydrate(r, DynamicReplicaFrameAnnotation) for r in raw]
