"""CMU mocap ASF/AMC file parsing.

Covers the capability of the reference parser
(`reference/amc_parser/amc_parser.py`: ``parse_asf`` :134,
``parse_amc`` :228) with a different design: instead of a recursive tree of
``Joint`` objects holding per-frame Python dicts, parsing produces

- a :class:`Skeleton` — structure-of-arrays bone data (directions, lengths,
  axis angles, dof channels, limits, parent indices) in topological order,
  ready for *batched* forward kinematics over all frames at once (see
  :mod:`gpmdm_tpu_torch.data.fk`), and
- a :class:`Motion` — per-joint channel arrays of shape (T, n_dof) instead of
  a list of per-frame dicts.

Behavioral parity notes:
- lengths and root translations are converted to meters with the CMU scale
  constant (1/0.45) * 2.54/100 (reference amc_parser.py:10, :172, :252);
  angles stay in degrees in the parsed output (converted inside FK).
- rotation-axis convention is static/extrinsic x-y-z ("sxyz"):
  ``R = Rz(az) @ Ry(ay) @ Rx(ax)`` — what the reference gets from
  ``transforms3d.euler.euler2mat`` (amc_parser.py:43) and what the ASF
  ``axis ... XYZ`` field specifies.
- the reference maps AMC channel values to x/y/z slots by scanning its
  per-axis ``limits`` rows and skipping rows that are exactly (0, 0)
  (amc_parser.py:64-69) — a latent bug if a real dof has limits (0, 0).
  Here channels are mapped by their dof *names* (``rx``/``ry``/``rz``),
  which is identical on all CMU data and robust in general.

A ``Joint``-tree facade mirroring the reference's public ``Joint`` API
(``set_motion`` / ``draw`` / ``to_dict``) lives in
:mod:`gpmdm_tpu_torch.data.joint_tree`.

A numpy-only copy of ``gpmdm_tpu/data/amc_asf.py`` for the port, which imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: CMU mocap length unit -> meters (reference amc_parser.py:10).
CMU_MOCAP_LENGTH_TO_METERS = (1 / 0.45) * 2.54 / 100

_ROT_DOFS = ("rx", "ry", "rz")


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """Structure-of-arrays ASF skeleton, joints in topological order
    (parents before children; joint 0 is the root).

    ``dof[j]`` lists joint j's motion channels in AMC file order.  Lengths
    are in meters; ``axis_deg`` in degrees.
    """

    names: Tuple[str, ...]  # (J,)
    parent: np.ndarray  # (J,) int, -1 for root
    direction: np.ndarray  # (J, 3) unit bone directions
    length: np.ndarray  # (J,) bone lengths, meters
    axis_deg: np.ndarray  # (J, 3) rotation-axis euler angles, degrees
    dof: Tuple[Tuple[str, ...], ...]  # per-joint channel names
    limits_deg: np.ndarray  # (J, 3, 2) per-axis (min, max), degrees

    @property
    def n_joints(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        return self.names.index(name)

    @property
    def children(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in self.names]
        for j, p in enumerate(self.parent):
            if p >= 0:
                out[int(p)].append(j)
        return out


@dataclasses.dataclass(frozen=True)
class Motion:
    """Parsed AMC motion: per-joint channel matrices, all frames at once.

    ``channels[name]`` has shape (T, len(skeleton.dof[name])) — degrees for
    rotation channels; the root's translation channels are in meters.
    """

    channels: Dict[str, np.ndarray]
    n_frames: int

    def frame(self, t: int) -> Dict[str, List[float]]:
        """Single frame as a {joint: [values]} dict (the reference's
        per-frame representation, amc_parser.py:243-258)."""
        return {name: list(arr[t]) for name, arr in self.channels.items()}

    def __len__(self) -> int:
        """Frame count — the reference's parse_amc returns a LIST of
        per-frame dicts (amc_parser.py:243-258), so ``len(motion)`` is
        part of its user surface (notebooks/joints.ipynb cell 2)."""
        return self.n_frames

    def __getitem__(self, t: int) -> Dict[str, List[float]]:
        """``motion[t]`` — the reference's list indexing idiom (its
        viewer/Joint.set_motion consume ``motions[frame_idx]`` dicts)."""
        return self.frame(t)


class ParseError(ValueError):
    pass


def _tokenize(path) -> List[List[str]]:
    text = Path(path).read_text()
    return [ln.split() for ln in text.splitlines()]


def parse_asf(file_path) -> Skeleton:
    """Parse an ASF skeleton file into a :class:`Skeleton`.

    Reads the ``:bonedata`` and ``:hierarchy`` sections (like the reference,
    which ignores ``:units``/``:root`` metadata, amc_parser.py:139-143).
    """
    lines = [ln for ln in _tokenize(file_path) if ln]
    # locate :bonedata
    try:
        start = next(i for i, ln in enumerate(lines) if ln[0] == ":bonedata")
    except StopIteration:
        raise ParseError(f"{file_path}: no :bonedata section")

    names: List[str] = ["root"]
    parents: Dict[str, str] = {}
    direction = {"root": np.zeros(3)}
    length = {"root": 0.0}
    axis_deg = {"root": np.zeros(3)}
    dof: Dict[str, Tuple[str, ...]] = {"root": ("tx", "ty", "tz", "rx", "ry", "rz")}
    limits: Dict[str, np.ndarray] = {"root": np.zeros((3, 2))}

    i = start + 1
    while i < len(lines) and lines[i][0] != ":hierarchy":
        if lines[i][0] != "begin":
            raise ParseError(f"{file_path}: expected 'begin', got {lines[i]}")
        i += 1
        bone: Dict[str, object] = {}
        bone_dof: List[str] = []
        bone_limits: List[Tuple[float, float]] = []
        while lines[i][0] != "end":
            key = lines[i][0]
            if key == "name":
                bone["name"] = lines[i][1]
            elif key == "direction":
                bone["direction"] = np.array([float(v) for v in lines[i][1:4]])
            elif key == "length":
                bone["length"] = float(lines[i][1]) * CMU_MOCAP_LENGTH_TO_METERS
            elif key == "axis":
                if len(lines[i]) < 5 or lines[i][4].upper() != "XYZ":
                    raise ParseError(
                        f"{file_path}: only 'axis ... XYZ' is supported, got {lines[i]}"
                    )
                bone["axis"] = np.array([float(v) for v in lines[i][1:4]])
            elif key == "dof":
                bone_dof = [tok.lower() for tok in lines[i][1:]]
                # limits follow: one (min max) pair per dof, first prefixed
                # with the 'limits' keyword
                for k in range(len(bone_dof)):
                    i += 1
                    toks = lines[i]
                    if k == 0:
                        if toks[0] != "limits":
                            raise ParseError(f"{file_path}: expected 'limits'")
                        toks = toks[1:]
                    lo = float(toks[0].lstrip("("))
                    hi = float(toks[1].rstrip(")"))
                    bone_limits.append((lo, hi))
            elif key == "id":
                pass
            else:
                raise ParseError(f"{file_path}: unknown bonedata key {key!r}")
            i += 1
        i += 1  # skip 'end'
        name = str(bone["name"])
        names.append(name)
        direction[name] = np.asarray(bone.get("direction", np.zeros(3)), dtype=np.float64)
        length[name] = float(bone.get("length", 0.0))
        axis_deg[name] = np.asarray(bone.get("axis", np.zeros(3)), dtype=np.float64)
        dof[name] = tuple(bone_dof)
        lim = np.zeros((3, 2))
        for d, (lo, hi) in zip(bone_dof, bone_limits):
            if d in _ROT_DOFS:
                lim[_ROT_DOFS.index(d)] = (lo, hi)
        limits[name] = lim

    if i >= len(lines):
        raise ParseError(f"{file_path}: no :hierarchy section")
    i += 1
    if lines[i][0] != "begin":
        raise ParseError(f"{file_path}: expected hierarchy 'begin'")
    i += 1
    while lines[i][0] != "end":
        parent_name, *children = lines[i]
        for ch in children:
            parents[ch] = parent_name
        i += 1

    # topological order: ASF bonedata order is parent-before-child on CMU
    # files, but don't rely on it — sort explicitly.
    order: List[str] = ["root"]
    remaining = [n for n in names if n != "root"]
    while remaining:
        progressed = False
        for n in list(remaining):
            if parents.get(n, "root") in order:
                order.append(n)
                remaining.remove(n)
                progressed = True
        if not progressed:
            raise ParseError(f"{file_path}: disconnected joints {remaining}")

    idx = {n: j for j, n in enumerate(order)}
    return Skeleton(
        names=tuple(order),
        parent=np.array([idx.get(parents.get(n, ""), -1) if n != "root" else -1 for n in order]),
        direction=np.stack([direction[n] for n in order]),
        length=np.array([length[n] for n in order]),
        axis_deg=np.stack([axis_deg[n] for n in order]),
        dof=tuple(dof[n] for n in order),
        limits_deg=np.stack([limits[n] for n in order]),
    )


def parse_amc(file_path, skeleton: Skeleton | None = None) -> Motion:
    """Parse an AMC motion file into per-joint channel arrays.

    Root translation channels (first 3 values of the ``root`` line) are
    converted to meters (reference amc_parser.py:252); everything else stays
    in degrees.
    """
    lines = _tokenize(file_path)
    # skip header: everything up to the :DEGREES marker (reference :232-234)
    body_start = 0
    for i, ln in enumerate(lines):
        if ln and ln[0].startswith(":DEGREES"):
            body_start = i + 1
            break

    per_joint: Dict[str, List[List[float]]] = {}
    n_frames = 0
    current_seen: set = set()
    for ln in lines[body_start:]:
        if not ln:
            continue
        if ln[0].lstrip("-").isdigit():  # frame number line
            n_frames += 1
            current_seen = set()
            continue
        if n_frames == 0:
            continue  # stray lines before the first frame index
        name = ln[0]
        vals = [float(v) for v in ln[1:]]
        if name == "root":
            vals = [
                v * CMU_MOCAP_LENGTH_TO_METERS if k < 3 else v
                for k, v in enumerate(vals)
            ]
        per_joint.setdefault(name, [])
        # pad joints that were missing in earlier frames
        while len(per_joint[name]) < n_frames - 1:
            per_joint[name].append([0.0] * len(vals))
        per_joint[name].append(vals)
        current_seen.add(name)

    channels = {}
    for name, rows in per_joint.items():
        width = max(len(r) for r in rows)
        arr = np.zeros((n_frames, width))
        for t, r in enumerate(rows):
            arr[t, : len(r)] = r
        channels[name] = arr
        if skeleton is not None and name in skeleton.names:
            expected = len(skeleton.dof[skeleton.index(name)])
            if width != expected:
                raise ParseError(
                    f"{file_path}: joint {name!r} has {width} channels, "
                    f"skeleton declares {expected} dof"
                )
    return Motion(channels=channels, n_frames=n_frames)
