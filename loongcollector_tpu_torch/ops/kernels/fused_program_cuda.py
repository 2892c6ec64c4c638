"""Build, bind and launch K7, the hand-written CUDA stage program.

The kernel (``csrc/fused_program.cu``) runs a pipeline's fused stage list
(``ops/fused_pipeline.py``) over rows it stages once: Tier-1 ``extract``
stages, DFA ``scan`` stages, filter ``keep`` stages with ``match``,
``extract_ok`` and ``span_match`` conditions, and ``struct_index`` stages
(K5's four bitmaps, ``csrc/struct_walk.cuh``).  It is built like K1's
(``field_extract_cuda.compile_library``: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/kernels/<source hash>/``, the hash covering the headers it
includes), loaded with ctypes, and watched by ``ops/compile_watch.py``.  A
build or launch failure raises; nothing here falls back to the plain
version.

The stage list is data: ``pack_descriptor`` turns it into one int32
descriptor (``FusedDescriptor.blob``)::

    [0, 16)              header (``_HEADER`` indices)
    stage records        8 words each: kind, section or first condition
                         (a struct_index stage: its mode), captures or
                         conditions (its separator), capture-state offset,
                         pivot, and the output arrays as bytes a row
                         before each (a struct_index stage: the bytes a
                         row of the fixed i32 arrays, and its first mask's
                         index among the mask arrays)
    condition records    16 words each (``COND_FIELDS``), 16-byte
                         aligned: kind, negate, section, producer stage,
                         capture, then what the test needs resolved: a
                         span condition's producer's final capture state
                         (its offset in words of T, past the forward copy
                         for a pivot program; its stride (3C | 1); its
                         capture count), an extract_ok condition's stride
                         and count, an automaton's states, start, first
                         settled state, accept and table offsets, and
                         whether its section lies in the shared part
    sections             Tier-1 programs (``KernelProgram.blob``) and
                         automata ([S, start, first_settled, 0], t256
                         [S][256] as words, accept [S]; the settled states
                         numbered from first_settled up)

The header, the records and the sections that fit come first, padded with
zeros to a multiple of 4 words: the kernel copies those ``shared_words``
into shared memory with 16-byte copies, so the row tile after them starts
16-byte aligned, and reads the rest from device memory.  A section goes to
shared memory when it fits beside the rows and capture state of the
smallest block (one warp) at the largest length bucket (``shared_cap``),
the first extract stage's program before every other, so every geometry
``launch_geometry`` picks holds it.  A stage list is never
refused for its size at a launch.

The outputs are one flat byte buffer of ``B * row_bytes_at(L)`` bytes: the
fixed i32 arrays first (each extract stage's ``cap_off`` and ``cap_len``,
each scan's tags), then the mask arrays (four a struct_index stage, each
``ceil(L / 16)`` i32 words a row, so the bytes a row follow ``L``), then
the byte arrays (each extract stage's ``ok``, each keep); an array lies at
``B`` times the bytes a row before it (``output_arrays``,
``OutputArray.offset``).
Importing this module needs no CUDA: only ``build()`` and ``launch()``
touch the toolchain and the card.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import compile_watch
from ..device_batch import LENGTH_BUCKETS
from . import field_extract_cuda as fxc
from .struct_index_cuda import MODES as STRUCT_MODES

MAGIC = 0x4B375046
HEADER_WORDS = 16
RECORD_WORDS = 8              # a stage record
COND_WORDS = 16               # a condition record
MAX_STAGES = 32               # kMaxStages in fused_program.cu
MAX_CONDS = 64
MAX_STATES = 128              # the DFA walk's cap (dfa_scan_cuda.MAX_STATES)

_HEADER = ["MAGIC", "NSTAGES", "SHARED_WORDS", "TOTAL_WORDS", "FIRST",
           "FIRST_STAGE", "GENERAL", "CAPS_WORDS", "SCRATCH_OFF",
           "ROW_BYTES", "NCONDS", "NWIDE"]
H = {name: i for i, name in enumerate(_HEADER)}
STAGE_KINDS = {"extract": 0, "scan": 1, "keep": 2, "struct_index": 3}
STRUCT_MASKS = ("in_string", "structural", "escaped", "quote")
COND_KINDS = {"match": 0, "extract_ok": 1, "span_match": 2}
COND_FIELDS = ["KIND", "NEG", "SEC", "PROD", "CAP", "FIN", "PCW", "PC", "S",
               "START", "FS", "ACC", "TAB", "SHARED"]
CF = {name: i for i, name in enumerate(COND_FIELDS)}

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "fused_program.cu")
ENTRY_POINT = "lct_fused_program"
BUILD_FAMILY = "fused_program_cuda.build"
LAUNCH_FAMILY = "fused_program_cuda.launch"


class FusedUnsupported(ValueError):
    """The stage list cannot be packed for the kernel."""


# -- the kernel's form of a stage list --------------------------------------

@dataclass(frozen=True)
class KernelCond:
    """One keep condition: ``kind`` "match" (``obj`` an AutomatonArrays
    over the row), "extract_ok" (``obj`` a KernelProgram) or "span_match"
    (an AutomatonArrays over capture ``cap`` of stage ``prod``)."""

    kind: str
    obj: object
    negate: bool = False
    prod: int = -1
    cap: int = -1


@dataclass(frozen=True)
class KernelStage:
    """One stage: "extract" (``obj`` a KernelProgram), "scan" (an
    AutomatonArrays), "keep" (``conds``) or "struct_index" (``obj`` a
    (mode, separator byte) pair, mode "json" or "delim")."""

    kind: str
    obj: object = None
    conds: Tuple[KernelCond, ...] = ()


@dataclass(frozen=True)
class OutputArray:
    """One array of the flat output: ``stage`` and its ``name`` (ok,
    cap_off, cap_len, tags, keep, or a struct_index stage's mask),
    ``width`` values a row of ``dtype`` (0 for a mask: ``ceil(L / 16)``
    words), at ``B * (unit + 4 * ceil(L / 16) * wide)`` bytes: ``wide`` is
    the count of mask arrays before it."""

    stage: int
    name: str
    dtype: str                # "int32" or "bool"
    width: int
    unit: int
    wide: int = 0

    @property
    def itemsize(self) -> int:
        return 4 if self.dtype == "int32" else 1

    @property
    def mask(self) -> bool:
        return self.width == 0

    def width_at(self, W: int) -> int:
        """Values a row when a mask row holds ``W`` words."""
        return W if self.mask else self.width

    def offset(self, B: int, W: int) -> int:
        return B * (self.unit + 4 * W * self.wide)


@dataclass
class FusedDescriptor:
    """A packed stage list: the int32 blob and what the host reads of it."""

    blob: np.ndarray
    shared_words: int
    first: int                # pivot of a depth-0 first program, or -1
    first_stage: int
    general: bool
    caps_words: int           # capture-state words a row
    row_bytes: int            # flat output bytes a row, masks aside
    outputs: List[OutputArray]
    placement: Dict[str, str]  # section name -> "shared" / "device"
    n_wide: int = 0           # mask arrays (four a struct_index stage)

    @property
    def instantiation(self) -> str:
        return instantiation_key(self.first, self.general)

    def row_bytes_at(self, L: int) -> int:
        """Flat output bytes a row at length ``L``: a mask array adds
        ``4 * ceil(L / 16)``."""
        return self.row_bytes + 4 * ((L + 15) // 16) * self.n_wide

    def flat_bytes(self, B: int, L: int) -> int:
        return B * self.row_bytes_at(L)


def instantiation_key(first: int, general: bool) -> str:
    """The name of a kernel instantiation, as ptxas_report keys it:
    ``d0_p0`` (the first extract stage's program at depth 0 without a
    pivot on its own walker), ``none`` (no extract stage on its own
    walker), ``_g`` when it calls the general walker."""
    base = "none" if first < 0 else f"d0_p{first}"
    return base + ("_g" if general else "")


INSTANTIATIONS = [instantiation_key(f, g) for f in range(-1, 3)
                  for g in (False, True)]


def _cap_words(C: int) -> int:
    return (3 * C) | 1


def _state_words(kprog) -> int:
    """Capture-state words a row of one Tier-1 program: (3C | 1), twice for
    a pivot program."""
    return _cap_words(kprog.num_caps) * (2 if kprog.pivot else 1)


def _automaton_words(arrays) -> np.ndarray:
    S = arrays.num_states
    if not 1 <= S <= MAX_STATES:
        raise FusedUnsupported(f"automaton of {S} states outside "
                               f"1..{MAX_STATES}")
    head = np.array([S, arrays.start, arrays.first_settled, 0], np.int32)
    t256 = np.ascontiguousarray(arrays.t256, dtype=np.uint8).reshape(-1)
    return np.concatenate([head, t256.view(np.int32),
                           np.asarray(arrays.accept, np.int32)])


def output_arrays(stages: Sequence[KernelStage]) -> Tuple[List[OutputArray],
                                                         int]:
    """The flat output's arrays in layout order (stage by stage: extract ok,
    cap_off, cap_len; scan tags; keep; struct_index in_string, structural,
    escaped, quote), and the bytes a row, masks aside.  In the buffer the
    fixed i32 arrays come first, then the masks, then the byte arrays, so
    every i32 array lies 4-byte aligned."""
    arrays: List[Tuple[int, str, str, int]] = []
    for si, st in enumerate(stages):
        if st.kind == "extract":
            C = st.obj.num_caps
            arrays += [(si, "ok", "bool", 1), (si, "cap_off", "int32", C),
                       (si, "cap_len", "int32", C)]
        elif st.kind == "scan":
            arrays.append((si, "tags", "int32", 1))
        elif st.kind == "struct_index":
            arrays += [(si, name, "int32", 0) for name in STRUCT_MASKS]
        else:
            arrays.append((si, "keep", "bool", 1))
    unit = 0
    units: Dict[int, Tuple[int, int]] = {}
    for i, (_si, _name, dtype, width) in enumerate(arrays):
        if dtype == "int32" and width:
            units[i] = (unit, 0)
            unit += 4 * width
    wide = 0
    for i, (_si, _name, dtype, width) in enumerate(arrays):
        if not width:
            units[i] = (unit, wide)
            wide += 1
    for i, (_si, _name, dtype, width) in enumerate(arrays):
        if dtype == "bool":
            units[i] = (unit, wide)
            unit += width
    return ([OutputArray(si, name, dtype, width, *units[i])
             for i, (si, name, dtype, width) in enumerate(arrays)], unit)


def _round4(words: int) -> int:
    return (words + 3) & ~3


def tile_words(L: int) -> int:
    """A staged row's stride in words: ceil(L / 4) + 1."""
    return (L + 3) // 4 + 1


def shared_cap(caps_words: int) -> int:
    """The descriptor words that fit in shared memory beside one warp's
    rows at the largest length bucket and their ``caps_words`` of capture
    state a row."""
    return fxc.SMEM_BUDGET // 4 - fxc.MIN_THREADS * (
        tile_words(LENGTH_BUCKETS[-1]) + caps_words)


def pack_descriptor(stages: Sequence[KernelStage]) -> FusedDescriptor:
    """The kernel's descriptor of a stage list; raises FusedUnsupported for
    a list the kernel cannot run (a stage kind it lacks, a span condition
    on a stage that is not an earlier extract, or a capture out of range,
    too many stages or conditions, an automaton over the state cap, a
    struct_index mode or separator it does not know)."""
    stages = list(stages)
    if not 1 <= len(stages) <= MAX_STAGES:
        raise FusedUnsupported(f"{len(stages)} stages outside "
                               f"1..{MAX_STAGES}")
    n_conds = sum(len(st.conds) for st in stages)
    if n_conds > MAX_CONDS:
        raise FusedUnsupported(f"{n_conds} conditions > {MAX_CONDS}")
    outputs, row_bytes = output_arrays(stages)
    out_units = {(o.stage, o.name): o.unit for o in outputs}
    out_wide = {(o.stage, o.name): o.wide for o in outputs}
    n_wide = sum(o.mask for o in outputs)

    # capture state: each extract stage's, then the general walker's scratch
    caps_off: Dict[int, int] = {}
    acc = 0
    scratch = 0
    for si, st in enumerate(stages):
        if st.kind not in STAGE_KINDS:
            raise FusedUnsupported(f"stage kind {st.kind!r}")
        if st.kind == "struct_index" and (
                st.obj[0] not in STRUCT_MODES or not 0 <= st.obj[1] <= 255):
            raise FusedUnsupported(f"struct_index stage {st.obj!r}")
        if st.kind == "extract":
            caps_off[si] = acc
            acc += _state_words(st.obj)
        for c in st.conds:
            if c.kind not in COND_KINDS:
                raise FusedUnsupported(f"condition kind {c.kind!r}")
            if c.kind == "extract_ok":
                scratch = max(scratch, _state_words(c.obj))
            elif c.kind == "span_match":
                if not (0 <= c.prod < si and stages[c.prod].kind == "extract"
                        and 0 <= c.cap < stages[c.prod].obj.num_caps):
                    raise FusedUnsupported(
                        f"span condition on stage {c.prod} capture {c.cap} "
                        f"is not an earlier extract stage's capture")
    scratch_off = acc
    caps_words = acc + scratch

    # sections, the first extract stage's program first
    first_stage = next((si for si, st in enumerate(stages)
                        if st.kind == "extract"), -1)
    sections: List[Tuple[str, np.ndarray]] = []
    if first_stage >= 0:
        sections.append((f"stage{first_stage}",
                         stages[first_stage].obj.blob))
    for si, st in enumerate(stages):
        if st.kind == "extract" and si != first_stage:
            sections.append((f"stage{si}", st.obj.blob))
        elif st.kind == "scan":
            sections.append((f"stage{si}", _automaton_words(st.obj)))
        for ci, c in enumerate(st.conds):
            words = (c.obj.blob if c.kind == "extract_ok"
                     else _automaton_words(c.obj))
            sections.append((f"stage{si}.cond{ci}", words))

    records = HEADER_WORDS + RECORD_WORDS * len(stages) + COND_WORDS * n_conds
    cap = shared_cap(caps_words)
    if _round4(records) > cap:
        raise FusedUnsupported(f"{records} descriptor words and {caps_words} "
                               f"capture words a row do not fit one warp's "
                               f"block at L={LENGTH_BUCKETS[-1]}")
    shared, device = [], []
    used = records
    for name, words in sections:
        if _round4(used + len(words)) <= cap:
            shared.append((name, words))
            used += len(words)
        else:
            device.append((name, words))
    pad = np.zeros(_round4(used) - used, np.int32)
    used += len(pad)
    offsets: Dict[str, int] = {}
    pos = records
    for name, words in shared + [("pad", pad)] + device:
        offsets[name] = pos
        pos += len(words)
    placement = {name: "shared" for name, _ in shared}
    placement.update({name: "device" for name, _ in device})

    first = -1
    if first_stage >= 0 and placement[f"stage{first_stage}"] == "shared" \
            and stages[first_stage].obj.depth == 0:
        first = stages[first_stage].obj.pivot
    general = any(
        (st.kind == "extract" and si != (first_stage if first >= 0 else -1))
        or any(c.kind == "extract_ok" for c in st.conds)
        for si, st in enumerate(stages))

    hdr = np.zeros(HEADER_WORDS, np.int32)
    hdr[H["MAGIC"]] = MAGIC
    hdr[H["NSTAGES"]] = len(stages)
    hdr[H["SHARED_WORDS"]] = used
    hdr[H["TOTAL_WORDS"]] = pos
    hdr[H["FIRST"]] = first
    hdr[H["FIRST_STAGE"]] = first_stage if first >= 0 else -1
    hdr[H["GENERAL"]] = int(general)
    hdr[H["CAPS_WORDS"]] = caps_words
    hdr[H["SCRATCH_OFF"]] = scratch_off
    hdr[H["ROW_BYTES"]] = row_bytes
    hdr[H["NCONDS"]] = n_conds
    hdr[H["NWIDE"]] = n_wide
    stage_rec = np.zeros((len(stages), RECORD_WORDS), np.int32)
    cond_rec = np.zeros((n_conds, COND_WORDS), np.int32)
    ci_all = 0
    for si, st in enumerate(stages):
        rec = stage_rec[si]
        rec[0] = STAGE_KINDS[st.kind]
        if st.kind == "extract":
            rec[1] = offsets[f"stage{si}"]
            rec[2] = st.obj.num_caps
            rec[3] = caps_off[si]
            rec[4] = st.obj.pivot
            rec[5:8] = [out_units[(si, n)] for n in ("ok", "cap_off",
                                                     "cap_len")]
        elif st.kind == "scan":
            rec[1] = offsets[f"stage{si}"]
            rec[5] = out_units[(si, "tags")]
        elif st.kind == "struct_index":
            rec[1] = STRUCT_MODES[st.obj[0]]
            rec[2] = st.obj[1]
            rec[5] = out_units[(si, STRUCT_MASKS[0])]
            rec[6] = out_wide[(si, STRUCT_MASKS[0])]
        else:
            if not st.conds:
                raise FusedUnsupported(f"keep stage {si} has no condition")
            rec[1] = ci_all
            rec[2] = len(st.conds)
            rec[5] = out_units[(si, "keep")]
            for ci, c in enumerate(st.conds):
                sec = f"stage{si}.cond{ci}"
                crec = cond_rec[ci_all]
                crec[CF["KIND"]] = COND_KINDS[c.kind]
                crec[CF["NEG"]] = int(c.negate)
                crec[CF["SEC"]] = offsets[sec]
                crec[CF["PROD"]] = c.prod
                crec[CF["CAP"]] = c.cap
                crec[CF["SHARED"]] = int(placement[sec] == "shared")
                if c.kind == "extract_ok":
                    crec[CF["PCW"]] = _cap_words(c.obj.num_caps)
                    crec[CF["PC"]] = c.obj.num_caps
                else:
                    a = c.obj
                    crec[CF["S"]] = a.num_states
                    crec[CF["START"]] = a.start
                    crec[CF["FS"]] = a.first_settled
                    crec[CF["TAB"]] = offsets[sec] + 4
                    crec[CF["ACC"]] = offsets[sec] + 4 + 64 * a.num_states
                if c.kind == "span_match":
                    prod = stages[c.prod].obj
                    pcw = _cap_words(prod.num_caps)
                    crec[CF["FIN"]] = caps_off[c.prod] + (pcw if prod.pivot
                                                          else 0)
                    crec[CF["PCW"]] = pcw
                    crec[CF["PC"]] = prod.num_caps
                ci_all += 1
    blob = np.concatenate([hdr, stage_rec.reshape(-1), cond_rec.reshape(-1)]
                          + [w for _, w in shared] + [pad]
                          + [w for _, w in device]).astype(np.int32)
    assert len(blob) == pos
    return FusedDescriptor(blob, used, first, hdr[H["FIRST_STAGE"]].item(),
                           general, caps_words, row_bytes, outputs,
                           placement, n_wide)


def smem_bytes(threads: int, L: int, desc: FusedDescriptor) -> int:
    """Dynamic shared memory of one block, as fused_program.cu lays it out:
    the shared part of the descriptor, the row tile, the capture state."""
    return 4 * (desc.shared_words
                + threads * (tile_words(L) + desc.caps_words))


def launch_geometry(B: int, L: int, desc: FusedDescriptor
                    ) -> Tuple[int, int]:
    """(threads per block, dynamic shared-memory bytes), as K1's
    ``launch_geometry``: 128 rows a block, halved down to one warp while the
    row tile exceeds ``ROW_TILE_BYTES``, the block does not fit the budget,
    or B would leave an SM without a block."""
    t = fxc.MAX_THREADS
    while t > fxc.MIN_THREADS and (
            t * L > fxc.ROW_TILE_BYTES
            or smem_bytes(t, L, desc) > fxc.SMEM_BUDGET
            or -(-B // t) < fxc.NUM_SMS):
        t //= 2
    smem = smem_bytes(t, L, desc)
    if smem > fxc.SMEM_BUDGET:
        raise ValueError(f"fused_program: {smem} bytes of shared memory for "
                         f"{t} rows of {L} bytes > {fxc.SMEM_BUDGET}")
    return t, smem


def split_flat(flat, B: int, desc: FusedDescriptor) -> list:
    """The flat output's arrays, in layout order, as views of ``flat``
    (a uint8 numpy array or tensor of ``desc.flat_bytes(B, L)``; the words
    a mask row holds follow from its size): [B] for a width of 1 (ok,
    tags, keep), else [B, C] or [B, ceil(L / 16)]."""
    out = []
    is_tensor = isinstance(flat, torch.Tensor)
    n = flat.numel() if is_tensor else len(flat)
    W = (n // B - desc.row_bytes) // (4 * desc.n_wide) \
        if desc.n_wide and B else 0
    for o in desc.outputs:
        start = o.offset(B, W)
        width = o.width_at(W)
        part = flat[start:start + B * width * o.itemsize]
        if is_tensor:
            part = part.view(torch.int32 if o.dtype == "int32"
                             else torch.bool)
        else:
            part = part.view(np.int32 if o.dtype == "int32" else np.bool_)
        out.append(part.reshape(B, width)
                   if o.name in ("cap_off", "cap_len") or o.mask else part)
    return out


# -- build -------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()
build_log = ""

_PTXAS_KERNEL = re.compile(
    r"fused_program_kernelILi(n?)(\d)ELb([01])E|extract_any")


def _ptxas_key(m: "re.Match") -> str:
    if m.group(2) is None:
        return "general_walker"
    first = -int(m.group(2)) if m.group(1) else int(m.group(2))
    return instantiation_key(first, m.group(3) == "1")


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """ptxas's registers, stack and spills per instantiation (keys as
    ``instantiation_key``), and the out-of-line general walker's
    (``general_walker``)."""
    return fxc.ptxas_report(log, _PTXAS_KERNEL, _ptxas_key)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library, and load
    every instantiation's code onto the current device."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so_path, build_log = fxc.compile_library(_SRC, "libfused_program.so",
                                                 BUILD_FAMILY)
        lib = ctypes.CDLL(so_path)
        vp, i32 = ctypes.c_void_p, ctypes.c_int32
        fn = getattr(lib, ENTRY_POINT)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_int64, i32, vp, i32, i32, vp, i32,
                       i32, vp, vp, vp]
        lib.lct_fused_error_string.restype = ctypes.c_char_p
        lib.lct_fused_error_string.argtypes = [ctypes.c_int]
        lib.lct_fused_prepare.restype = ctypes.c_int
        lib.lct_fused_prepare.argtypes = []
        rc = lib.lct_fused_prepare()
        if rc != 0:
            raise RuntimeError("fused_program: loading the kernels failed: "
                               + lib.lct_fused_error_string(rc).decode())
        _lib = lib
        return lib


# -- launch ------------------------------------------------------------------

@dataclass(frozen=True)
class LaunchShape:
    """What one launch passed to the C entry point: the instantiation, the
    batch, threads per block, dynamic shared-memory bytes, the grid
    (ceil(B / threads) blocks), and the descriptor's shared and device
    words."""

    instantiation: str
    B: int
    L: int
    threads: int
    smem: int
    blocks: int
    shared_words: int
    device_words: int


launch_shapes: Dict[LaunchShape, int] = {}
_shapes_lock = threading.Lock()


def reset_launch_shapes() -> None:
    with _shapes_lock:
        launch_shapes.clear()


def launch(rows: torch.Tensor, lengths: torch.Tensor, blob: torch.Tensor,
           desc: FusedDescriptor, events=None) -> torch.Tensor:
    """One K7 launch on PyTorch's current stream, without a synchronise:
    rows u8 [B, L], lengths i32 [B] and the descriptor ``blob`` (i32, on
    the card) on one CUDA device, contiguous.  Returns the flat output, u8
    ``[desc.flat_bytes(B, L)]`` (``split_flat`` views it).  ``events``, a
    (start, end) pair of timing CUDA events when given, is recorded by the
    entry point right around the kernel."""
    dev = rows.device
    if dev.type != "cuda" or lengths.device != dev or blob.device != dev:
        raise ValueError("fused_program: rows, lengths and the descriptor "
                         "must lie on one CUDA device")
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"fused_program: rows must be u8 [B, L], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    B, L = rows.shape
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"fused_program: lengths must be i32 [{B}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if blob.dtype != torch.int32 or blob.numel() != len(desc.blob):
        raise ValueError("fused_program: the descriptor on the card is not "
                         "the packed one")
    if blob.data_ptr() % 16:
        raise ValueError("fused_program: the descriptor must be 16-byte "
                         "aligned (it is copied 16 bytes at a time)")
    if not (rows.is_contiguous() and lengths.is_contiguous()
            and blob.is_contiguous()):
        raise ValueError("fused_program: inputs must be contiguous")
    lib = build()
    threads, smem = launch_geometry(B, L, desc)
    shape = LaunchShape(desc.instantiation, B, L, threads, smem,
                        -(-B // threads), desc.shared_words,
                        len(desc.blob) - desc.shared_words)
    out = torch.empty(desc.flat_bytes(B, L), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev)
    handles = (None, None)
    if events is not None:
        for ev in events:
            ev.record(stream)         # torch makes the event's handle here
        handles = (events[0].cuda_event, events[1].cuda_event)
        if not all(handles):
            raise RuntimeError("fused_program: a timing event has no CUDA "
                               "handle")
    t0 = time.perf_counter()
    rc = getattr(lib, ENTRY_POINT)(
        rows.data_ptr(), lengths.data_ptr(), B, L, blob.data_ptr(),
        desc.first, int(desc.general), out.data_ptr(), threads, smem,
        stream.cuda_stream, *handles)
    if rc != 0:
        raise RuntimeError("fused_program launch failed: "
                           + lib.lct_fused_error_string(rc).decode())
    compile_watch.note_call(LAUNCH_FAMILY, f"{shape.instantiation}:{B}x{L}",
                            t0)
    with _shapes_lock:
        launch_shapes[shape] = launch_shapes.get(shape, 0) + 1
    return out
