"""Flat KEY:VALUE cfg parser — port of ``neutronstarlite_tpu/utils/config.py``.

Same on-disk format (the reference's ``InputInfo::readFromCfgFile``): one
``KEY:VALUE`` per line, ``#`` comments, dash-separated ``LAYERS``. Unlike
the JAX parser, which ignores keys it does not know, this one refuses every
key and every ALGORITHM the port does not implement yet with a one-line
``ValueError``: a knob that would be silently ignored lets a user benchmark
a path that never runs.

The port honours the single-device full-batch keys (GCN, GAT, GIN,
CommNet, GGCN) and the sampled trainer's (``GCNSAMPLE*``: ``BATCH_SIZE``,
dash-separated ``FANOUT``, ``SAMPLE_PIPELINE`` = sync, pipelined, device or
fused; a full-batch trainer given ``SAMPLE_PIPELINE`` refuses it).
``KERNEL`` is empty (the edge chain) or ``fused_edge`` (``ops/fused_edge.py``,
GAT and GGCN). ``ELL_LEVELS`` (``pow2`` or ``binned``) sets the fused tables'
level ladder. ``KERNEL_TILE`` sets the source-tile height of the bsp
kernel (``PALLAS:1``), of the blocked ELL route (``OPTIM_KERNEL:1``
without ``PALLAS``) and of the fused tables. ``PROC_CUDA`` and ``LOCK_FREE`` are
reference compatibility flags that the single-device trainer has no use for
(the JAX trainer ignores them too; the port's device comes from
``--device``); ``PROC_OVERLAP`` and ``PROC_LOCAL`` select distributed
features and are accepted only at their single-device values.
The distributed trainers (``GCNDIST``, ``GCNEAGERDIST``, ``GINDIST``,
``COMMNETDIST``, ``models/gcn_dist.py``; ``GATDIST``, ``GGCNDIST``,
``TEST_GETDEP`` and the DepCache ``GCNDISTCACHE`` over the uniform mirror)
read ``PARTITIONS`` (any count), ``COMM_LAYER`` (``ring``,
``ell``, ``mirror`` or ``auto``), ``DIST_PATH`` (``all_gather``,
``ring_blocked``, ``ring_blocked_sim`` or ``auto``), ``WIRE_DTYPE`` (``f32``
or ``bf16``; ``NTS_WIRE_DTYPE`` wins) and ``MESH`` (``Pv,Pf`` or
``PvxPf``; ``NTS_MESH`` wins, ``parallel/partitioner.py``); a single-device
trainer refuses these keys at the parse (PARTITIONS above 1). The DepCache
keys ``PROC_REP``, ``REP_THRESHOLD`` (an out-degree, or ``auto``: -1),
``CACHE_BUDGET_MIB`` and ``CACHE_REFRESH`` are read by ``GCNDISTCACHE``
alone; any other trainer refuses them away from their defaults.
``CHECKPOINT_DIR`` and ``CHECKPOINT_EVERY`` turn on
checkpoints (``utils/checkpoint.py``); ``CKPT_BACKEND`` takes ``npz`` alone:
``orbax`` is a JAX library, and the sharded asynchronous saves it gives
the reference come with the distributed slice. The serving keys
(``SERVE_MAX_BATCH``, ``SERVE_MAX_WAIT_MS``, ``SERVE_MAX_QUEUE``,
``SERVE_BUCKETS``, ``SERVE_CACHE_CAP``, ``SERVE_CACHE_MAX_AGE_S``,
``SERVE_HOT_THRESHOLD``, ``SERVE_REPLICAS``, ``SERVE_ROUTE``, ``SERVE_CB``)
parse as in the reference; ``serve/`` reads them.

``auto`` parses on the six axes the autotuner owns (``DIST_PATH``,
``KERNEL``, ``ELL_LEVELS``, ``WIRE_DTYPE``, ``MESH``, ``SAMPLE_PIPELINE``;
``tune/``): the trainer's funnel resolves it through ``NTS_TUNE`` before
any table is built. With ``NTS_TUNE=off`` (the default) every one but
``DIST_PATH:auto``, which keeps its legacy meaning, is refused there
(``check_unresolved_autos`` is the funnel's backstop).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

# ALGORITHM strings of the single-device full-batch trainers (models/
# registers the same names)
GCN_ALGORITHMS = ("GCNCPU", "GCN", "GCNTPU")
GCN_EAGER_ALGORITHMS = ("GCNCPUEAGER", "GCNEAGER", "GCNEAGERSINGLE", "GCN_CPU_EAGER")
GAT_ALGORITHMS = ("GATCPU", "GAT", "GATSINGLE")
GIN_ALGORITHMS = ("GINCPU", "GINGPU", "GIN")
COMMNET_ALGORITHMS = ("COMMNETGPU", "COMMNETCPU", "COMMNET")
GGCN_ALGORITHMS = ("GGCNCPU", "GGCN", "GGNN")
GCN_SAMPLE_ALGORITHMS = ("GCNSAMPLESINGLE", "GCNSAMPLE", "GCNCPUSAMPLE")
# the distributed trainers (models/gcn_dist.py, gin_dist.py, commnet_dist.py)
GCN_DIST_ALGORITHMS = ("GCNDIST", "GCNTPUDIST")
GCN_EAGER_DIST_ALGORITHMS = ("GCNEAGERDIST", "GCNDISTEAGER", "GCNEAGERTPUDIST")
GIN_DIST_ALGORITHMS = ("GINDIST", "GINTPUDIST", "GINCPUDIST")
COMMNET_DIST_ALGORITHMS = ("COMMNETDIST", "COMMNETTPUDIST", "COMMNETGPUDIST")
# over the uniform mirror exchange (models/gat_dist.py, ggcn_dist.py,
# test_getdep.py, gcn_dist_cache.py)
GAT_DIST_ALGORITHMS = ("GATCPUDIST", "GATGPUDIST", "GATDIST", "GATCPUDISTOPTM")
GGCN_DIST_ALGORITHMS = ("GGCNDIST", "GGCNCPUDIST", "GGNNDIST")
TEST_GETDEP_ALGORITHMS = ("TEST_GETDEP1", "TEST_GETDEP", "TESTGETDEP")
GCN_CACHE_DIST_ALGORITHMS = ("GCNDISTMIRROR", "GCNDISTCACHE", "GCNDISTREP")
DIST_ALGORITHMS = (
    GCN_DIST_ALGORITHMS + GCN_EAGER_DIST_ALGORITHMS + GIN_DIST_ALGORITHMS
    + COMMNET_DIST_ALGORITHMS + GAT_DIST_ALGORITHMS + GGCN_DIST_ALGORITHMS
    + TEST_GETDEP_ALGORITHMS + GCN_CACHE_DIST_ALGORITHMS
)
SUPPORTED_ALGORITHMS = (
    GCN_ALGORITHMS + GCN_EAGER_ALGORITHMS + GAT_ALGORITHMS + GIN_ALGORITHMS
    + COMMNET_ALGORITHMS + GGCN_ALGORITHMS + GCN_SAMPLE_ALGORITHMS + DIST_ALGORITHMS
)
# the slice that brings what this one refuses
PLANE_SLICE = (
    "the last distributed slice of the torch port (skew, elastic replan, "
    "numerics, DEBUGINFO and the quantisation probe on the dist trainers)"
)
SAMPLE_PIPELINE_MODES = ("sync", "pipelined", "device", "fused")

_INT_KEYS = {
    "VERTICES": "vertices",
    "EPOCHS": "epochs",
    "DECAY_EPOCH": "decay_epoch",
    "KERNEL_TILE": "kernel_tile",
    "CHECKPOINT_EVERY": "checkpoint_every",
    "BATCH_SIZE": "batch_size",
    "CACHE_BUDGET_MIB": "cache_budget_mib",
    "CACHE_REFRESH": "cache_refresh",
    "SERVE_MAX_BATCH": "serve_max_batch",
    "SERVE_MAX_QUEUE": "serve_max_queue",
    "SERVE_CACHE_CAP": "serve_cache_cap",
    "SERVE_HOT_THRESHOLD": "serve_hot_threshold",
    "SERVE_REPLICAS": "serve_replicas",
    "SERVE_CB": "serve_cb",
}
_FLOAT_KEYS = {
    "LEARN_RATE": "learn_rate",
    "WEIGHT_DECAY": "weight_decay",
    "DECAY_RATE": "decay_rate",
    "DROP_RATE": "drop_rate",
    "SERVE_MAX_WAIT_MS": "serve_max_wait_ms",
    "SERVE_CACHE_MAX_AGE_S": "serve_cache_max_age_s",
}
_BOOL_KEYS = {
    "PROC_CUDA": "with_cuda",
    "LOCK_FREE": "lock_free",
    "OPTIM_KERNEL": "optim_kernel",
    "PALLAS": "pallas_kernel",
    "SUBLINEAR": "sublinear",
}
_STR_KEYS = {
    "LAYERS": "layer_string",
    "EDGE_FILE": "edge_file",
    "FEATURE_FILE": "feature_file",
    "LABEL_FILE": "label_file",
    "MASK_FILE": "mask_file",
    "CHECKPOINT_DIR": "checkpoint_dir",
    "FANOUT": "fanout_string",
    "SERVE_BUCKETS": "serve_buckets",
    "SERVE_ROUTE": "serve_route",
}
# distributed switches: accepted only at the single-device value (and
# recorded, as the reference records them, for the config fingerprint)
_SINGLE_DEVICE_KEYS = {
    "PROC_OVERLAP": ("0",),
    "PROC_LOCAL": ("0",),
}
_SINGLE_DEVICE_FIELDS = {
    "PROC_OVERLAP": ("process_overlap", lambda v: bool(int(v))),
    "PROC_LOCAL": ("process_local", lambda v: bool(int(v))),
}
COMM_LAYERS = ("", "auto", "ring", "ell", "mirror")
# the axes the autotuner resolves besides DIST_PATH, whose auto predates it
TUNER_ONLY_AXES = ("kernel", "ell_levels", "wire_dtype", "mesh", "sample_pipeline")
DIST_PATHS = ("", "auto", "all_gather", "ring_blocked", "ring_blocked_sim")
WIRE_DTYPES = ("", "auto", "f32", "float32", "bf16", "bfloat16")

# every field of the reference's InputInfo with its default, in its order:
# the obs config fingerprint (obs/registry.config_fingerprint) is a digest
# of this dict, so the port fingerprints a cfg as the reference does
REFERENCE_FIELDS = {
    "algorithm": "", "vertices": 0, "epochs": 10, "batch_size": 64,
    "layer_string": "", "fanout_string": "", "edge_file": "", "feature_file": "",
    "label_file": "", "mask_file": "", "learn_rate": 0.01, "weight_decay": 0.0001,
    "decay_rate": 0.97, "decay_epoch": 100, "drop_rate": 0.5,
    "process_overlap": False, "process_local": False, "with_cuda": False,
    "process_rep": False, "lock_free": False, "optim_kernel": False, "partitions": 0,
    "precision": "float32", "checkpoint_dir": "", "checkpoint_every": 0,
    "ckpt_backend": "", "rep_threshold": 0, "cache_budget_mib": 256,
    "cache_refresh": 1, "sublinear": False, "undirected": False,
    "data_format": "auto", "comm_layer": "auto", "dist_path": "", "mesh": "",
    "wire_dtype": "", "ell_levels": "", "kernel_tile": 0, "kernel": "",
    "pallas_kernel": False, "edge_chunk": 0, "serve_max_batch": 16,
    "serve_max_wait_ms": 5.0, "serve_max_queue": 256, "serve_buckets": "",
    "serve_cache_cap": 0, "serve_cache_max_age_s": 60.0, "serve_hot_threshold": 0,
    "serve_replicas": 1, "serve_route": "", "serve_cb": 0, "sample_pipeline": "",
}


@dataclasses.dataclass
class InputInfo:
    """Parsed cfg (the fields of the JAX ``InputInfo`` that slice 1 uses)."""

    algorithm: str = ""
    vertices: int = 0
    epochs: int = 10
    layer_string: str = ""
    edge_file: str = ""
    feature_file: str = ""
    label_file: str = ""
    mask_file: str = ""
    learn_rate: float = 0.01
    weight_decay: float = 0.0001
    decay_rate: float = 0.97
    decay_epoch: int = 100
    drop_rate: float = 0.5
    with_cuda: bool = False
    lock_free: bool = False
    optim_kernel: bool = False
    pallas_kernel: bool = False
    kernel_tile: int = 0  # source-tile height: bsp kernel, blocked ELL, fused tables
    precision: str = "float32"  # or "bfloat16"
    sublinear: bool = False  # activation recomputation (torch.utils.checkpoint)
    kernel: str = ""  # KERNEL: "" (the edge chain) or fused_edge
    ell_levels: str = ""  # ELL_LEVELS: "" (the path's default), pow2 or binned
    checkpoint_dir: str = ""  # checkpoint and resume when set
    checkpoint_every: int = 0  # epochs between checkpoints (0: at the end only)
    ckpt_backend: str = ""  # CKPT_BACKEND: "" (NTS_CKPT_BACKEND, else npz) or npz
    batch_size: int = 64  # sampled trainer: seeds per mini-batch
    fanout_string: str = ""  # sampled trainer: FANOUT, e.g. "25-10"
    sample_pipeline: str = ""  # SAMPLE_PIPELINE: "" (sync) or one of SAMPLE_PIPELINE_MODES
    # online serving (serve/); each has an NTS_SERVE_* override, resolved in
    # serve.batcher.ServeOptions.from_cfg and serve.fleet.FleetOptions.from_cfg
    serve_max_batch: int = 16  # micro-batch flush size == largest bucket
    serve_max_wait_ms: float = 5.0  # deadline coalescing window per flush
    serve_max_queue: int = 256  # pending-request bound; beyond it: shed
    serve_buckets: str = ""  # dash-separated bucket ladder; "" = geometric x4
    serve_cache_cap: int = 0  # inference embedding cache entries (0 = off)
    serve_cache_max_age_s: float = 60.0  # cache staleness bound (seconds)
    serve_hot_threshold: int = 0  # out-degree >= threshold => cacheable
    serve_replicas: int = 1  # serve-fleet size (serve/fleet.py)
    serve_route: str = ""  # fleet routing policy: least_burn | round_robin
    serve_cb: int = 0  # continuous batching (serve/batcher.py)
    # distributed switches at their single-device values
    process_overlap: bool = False
    process_local: bool = False
    # the DepCache GCN (models/gcn_dist_cache.py): replicate / cache the hot
    # mirror rows; REP_THRESHOLD is an out-degree (-1: auto, the smallest
    # that fits CACHE_BUDGET_MIB); CACHE_REFRESH epochs between refreshes
    process_rep: bool = False
    rep_threshold: int = 0
    cache_budget_mib: int = 256
    cache_refresh: int = 1
    # the distributed trainers: partition count (0: the world size),
    # exchange layer and path
    partitions: int = 0
    comm_layer: str = "auto"
    dist_path: str = ""
    mesh: str = ""  # MESH: "" (1D) or "Pv,Pf" (parallel/partitioner.py)
    wire_dtype: str = ""  # WIRE_DTYPE: the pipelined ring's wire dtype

    @staticmethod
    def read_from_cfg_file(path: str) -> "InputInfo":
        cfg = InputInfo()
        with open(path, "r") as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith("#") or ":" not in line:
                    continue
                key, _, value = line.partition(":")
                cfg._apply(key.strip().upper(), value.strip())
        check_dist_keys(cfg)
        return cfg

    def _apply(self, key: str, value: str) -> None:
        if key == "ALGORITHM":
            check_algorithm(value)
            self.algorithm = value
        elif key in _INT_KEYS:
            setattr(self, _INT_KEYS[key], int(value))
        elif key in _FLOAT_KEYS:
            setattr(self, _FLOAT_KEYS[key], float(value))
        elif key in _BOOL_KEYS:
            setattr(self, _BOOL_KEYS[key], bool(int(value)))
        elif key in _STR_KEYS:
            setattr(self, _STR_KEYS[key], value)
        elif key == "KERNEL":
            self.kernel = value.strip().lower()
            _check_kernel(self.kernel)
        elif key == "ELL_LEVELS":
            self.ell_levels = value.strip().lower()
            _check_ell_levels(self.ell_levels)
        elif key == "SAMPLE_PIPELINE":
            self.sample_pipeline = value.strip().lower()
            check_sample_pipeline(self.sample_pipeline)
        elif key == "CKPT_BACKEND":
            check_ckpt_backend(value)
            self.ckpt_backend = value
        elif key == "PARTITIONS":
            self.partitions = int(value)
            if self.partitions < 0:
                raise ValueError(f"PARTITIONS must be >= 0, got {value!r}")
        elif key == "COMM_LAYER":
            self.comm_layer = value.strip().lower()
            check_comm_layer(self.comm_layer)
        elif key == "DIST_PATH":
            self.dist_path = value.strip().lower()
            check_dist_path(self.dist_path)
        elif key == "WIRE_DTYPE":
            self.wire_dtype = value.strip().lower()
            check_wire_dtype(self.wire_dtype)
        elif key == "MESH":
            self.mesh = check_mesh(value)
        elif key == "PROC_REP":
            self.process_rep = bool(int(value))
        elif key == "REP_THRESHOLD":
            self.rep_threshold = -1 if value.lower() == "auto" else int(value)
        elif key == "PRECISION":
            if value not in ("float32", "bfloat16"):
                raise ValueError(
                    f"PRECISION must be float32 or bfloat16, got {value!r}"
                )
            self.precision = value
        elif key in _SINGLE_DEVICE_KEYS:
            if value not in _SINGLE_DEVICE_KEYS[key]:
                raise ValueError(
                    f"{key}:{value} selects a distributed feature the torch "
                    "port does not implement yet (single device only)"
                )
            field, parse = _SINGLE_DEVICE_FIELDS[key]
            setattr(self, field, parse(value))
        else:
            raise ValueError(
                f"cfg key {key}:{value} is not implemented by the torch port yet"
            )

    def reference_dict(self) -> dict:
        """This cfg as the reference's ``dataclasses.asdict(InputInfo)``:
        its defaults, with this cfg's values laid over them."""
        return dict(REFERENCE_FIELDS, **dataclasses.asdict(self))

    def layer_sizes(self) -> List[int]:
        """Parse "1433-128-7" -> [1433, 128, 7]."""
        if not self.layer_string:
            return []
        return [int(tok) for tok in self.layer_string.split("-") if tok]

    def fanouts(self) -> List[int]:
        """Parse "5-10-10" -> [5, 10, 10]."""
        if not self.fanout_string:
            return []
        return [int(tok) for tok in self.fanout_string.split("-") if tok]

    def serve_bucket_list(self) -> List[int]:
        """Parse SERVE_BUCKETS:1-4-16 -> [1, 4, 16] (the bucket ladder;
        empty = derive geometrically, serve.batcher.ServeOptions)."""
        if not self.serve_buckets:
            return []
        return [int(tok) for tok in self.serve_buckets.split("-") if tok]

    def resolve_path(self, path: str, base_dir: Optional[str] = None) -> str:
        """Data paths resolve relative to the cfg file's directory."""
        if not path or os.path.isabs(path) or not base_dir:
            return path
        return os.path.normpath(os.path.join(base_dir, path))

    def print(self) -> str:
        """Config echo (same lines as the JAX CLI)."""
        lines = [
            f"ALGORITHM: {self.algorithm}",
            f"VERTICES: {self.vertices}",
            f"LAYERS: {self.layer_string}",
            f"FANOUT: {self.fanout_string}",
            f"EPOCHS: {self.epochs}",
            f"BATCH_SIZE: {self.batch_size}",
            f"EDGE_FILE: {self.edge_file}",
            f"FEATURE_FILE: {self.feature_file}",
            f"LABEL_FILE: {self.label_file}",
            f"MASK_FILE: {self.mask_file}",
            f"LEARN_RATE: {self.learn_rate}",
            f"WEIGHT_DECAY: {self.weight_decay}",
            f"DECAY_RATE: {self.decay_rate}",
            f"DECAY_EPOCH: {self.decay_epoch}",
            f"DROP_RATE: {self.drop_rate}",
            f"OPTIM_KERNEL: {int(self.optim_kernel)}",
            f"PALLAS: {int(self.pallas_kernel)}",
            f"PRECISION: {self.precision}",
        ]
        return "\n".join(lines)


def check_algorithm(value: str) -> None:
    """Refuse an ALGORITHM the port does not implement."""
    name = value.upper()
    if name not in SUPPORTED_ALGORITHMS:
        raise ValueError(
            f"ALGORITHM {value!r} is not ported yet; the torch port "
            f"implements {', '.join(SUPPORTED_ALGORITHMS)}"
        )


def check_dist_keys(cfg: "InputInfo") -> None:
    """Refuse the distributed trainers' keys (PARTITIONS above 1, COMM_LAYER,
    DIST_PATH, MESH, WIRE_DTYPE; ``auto``, which the autotuner resolves to
    the empty value there, passes) on a single-device trainer, and the
    DepCache keys on any trainer but the DepCache GCN, which would ignore
    them."""
    name = cfg.algorithm.upper()
    if name not in GCN_CACHE_DIST_ALGORITHMS:
        given = [f"{key}:{value}" for key, value, unset in (
            ("PROC_REP", int(cfg.process_rep), not cfg.process_rep),
            ("REP_THRESHOLD", cfg.rep_threshold, cfg.rep_threshold == 0),
            ("CACHE_BUDGET_MIB", cfg.cache_budget_mib, cfg.cache_budget_mib == 256),
            ("CACHE_REFRESH", cfg.cache_refresh, cfg.cache_refresh == 1)) if not unset]
        if given:
            raise ValueError(
                f"{', '.join(given)} is read only by the DepCache GCN "
                f"({', '.join(GCN_CACHE_DIST_ALGORITHMS)}); ALGORITHM {cfg.algorithm!r} "
                "would ignore it: drop the key"
            )
    if name in DIST_ALGORITHMS:
        return
    given = [f"{key}:{value}" for key, value, unset in (
        ("PARTITIONS", cfg.partitions, cfg.partitions <= 1),
        ("COMM_LAYER", cfg.comm_layer, cfg.comm_layer in ("", "auto")),
        ("DIST_PATH", cfg.dist_path, cfg.dist_path in ("", "auto")),
        ("MESH", cfg.mesh, cfg.mesh in ("", "auto")),
        ("WIRE_DTYPE", cfg.wire_dtype, cfg.wire_dtype in ("", "auto"))) if not unset]
    if given:
        raise ValueError(
            f"{', '.join(given)} is read only by the distributed trainers "
            f"({', '.join(DIST_ALGORITHMS)}); ALGORITHM {cfg.algorithm!r} runs on "
            "one device: drop the key (or set PARTITIONS to 1)"
        )


def check_comm_layer(value: str) -> None:
    if value not in COMM_LAYERS:
        raise ValueError(f"COMM_LAYER must be ring, ell, mirror or auto, got {value!r}")


def check_dist_path(value: str) -> None:
    if value not in DIST_PATHS:
        raise ValueError(
            "DIST_PATH must be auto, all_gather, ring_blocked or ring_blocked_sim, "
            f"got {value!r}"
        )


def check_wire_dtype(value: str) -> None:
    if value not in WIRE_DTYPES:
        raise ValueError(
            f"WIRE_DTYPE must be f32/float32 or bf16/bfloat16, auto (or empty), got {value!r}"
        )


def check_mesh(value: str) -> str:
    """The canonical MESH value ('', 'auto' or 'Pv,Pf')."""
    from neutronstarlite_torch.parallel.partitioner import normalize_mesh_value

    return normalize_mesh_value(value)


def _check_kernel(value: str) -> None:
    if value not in ("", "auto", "fused_edge"):
        raise ValueError(f"KERNEL must be fused_edge or auto (or empty), got {value!r}")


def _check_ell_levels(value: str) -> None:
    if value not in ("", "auto", "pow2", "binned"):
        raise ValueError(
            f"ELL_LEVELS must be pow2, binned or auto (or empty), got {value!r}")


def check_sample_pipeline(value: str) -> None:
    """Refuse an unknown SAMPLE_PIPELINE (``auto`` is the tuner's)."""
    if value not in ("", "auto") + SAMPLE_PIPELINE_MODES:
        raise ValueError(
            f"SAMPLE_PIPELINE must be sync, pipelined, device, fused or auto, got {value!r}"
        )


def tuner_off_refusal(axes) -> ValueError:
    """The refusal of tuner-only ``auto`` axes while the autotuner is off
    (JAX's ``tune/select.py`` wording)."""
    return ValueError(
        f"{', '.join(sorted(a.upper() for a in axes))}:auto "
        "requested but the autotuner is off (NTS_TUNE=off): set "
        "NTS_TUNE=cached or NTS_TUNE=measure (and NTS_TUNE_DIR "
        "for persistence), or pin a concrete value — silently "
        "running a default while the cfg says auto is the "
        "mis-benchmark the lifecycle funnel exists to refuse"
    )


def check_unresolved_autos(cfg: InputInfo) -> None:
    """The funnel's backstop: a tuner-only axis still ``auto`` here was not
    resolved (``tune.select.resolve_auto_knobs`` runs first and refuses
    these under ``NTS_TUNE=off``)."""
    left = [a for a in TUNER_ONLY_AXES if getattr(cfg, a, "") == "auto"]
    if left:
        raise tuner_off_refusal(left)


def check_ckpt_backend(value: str) -> str:
    """The checkpoint backend ``value`` names (empty: ``NTS_CKPT_BACKEND``,
    else npz); refuses orbax and unknown names."""
    backend = value or os.environ.get("NTS_CKPT_BACKEND", "") or "npz"
    if backend == "orbax":
        raise ValueError(
            "checkpoint backend orbax (CKPT_BACKEND / NTS_CKPT_BACKEND) is a JAX "
            "library; the torch port writes npz checkpoints, and sharded "
            "asynchronous saves come with the distributed slice: set npz"
        )
    if backend != "npz":
        raise ValueError(
            f"unknown checkpoint backend {backend!r} (CKPT_BACKEND / "
            "NTS_CKPT_BACKEND: npz)"
        )
    return backend


def check_supported(cfg: InputInfo, resident: bool, supports_fused_edge: bool = False) -> None:
    """Cross-key refusals at the trainer's lifecycle funnel (cfgs built in
    code skip the file parser, so the per-key checks repeat here).
    ``resident`` is the NTS_PALLAS_RESIDENT=1 switch (the ELL-level kernel
    instead of the bsp kernel under PALLAS:1); ``supports_fused_edge`` is
    the trainer's flag (GAT, GGCN)."""
    check_algorithm(cfg.algorithm)
    check_comm_layer(cfg.comm_layer)
    check_dist_path(cfg.dist_path)
    check_wire_dtype(cfg.wire_dtype)
    check_mesh(cfg.mesh)
    check_dist_keys(cfg)
    if cfg.precision not in ("float32", "bfloat16"):
        raise ValueError(
            f"PRECISION must be float32 or bfloat16, got {cfg.precision!r}"
        )
    _check_kernel(cfg.kernel)
    _check_ell_levels(cfg.ell_levels)
    check_sample_pipeline(cfg.sample_pipeline)
    check_unresolved_autos(cfg)
    if cfg.sample_pipeline and cfg.algorithm.upper() not in GCN_SAMPLE_ALGORITHMS:
        raise ValueError(
            f"SAMPLE_PIPELINE:{cfg.sample_pipeline} is not available for ALGORITHM "
            f"{cfg.algorithm!r}: only the sampled trainer "
            f"({', '.join(GCN_SAMPLE_ALGORITHMS)}) samples; drop the key"
        )
    if cfg.checkpoint_dir:
        check_ckpt_backend(cfg.ckpt_backend)
    if cfg.pallas_kernel and not cfg.optim_kernel:
        raise ValueError(
            "PALLAS:1 requires OPTIM_KERNEL:1 (the kernels are layouts of the "
            "OPTIM_KERNEL aggregation path)"
        )
    if cfg.kernel == "fused_edge":
        if not supports_fused_edge:
            raise ValueError(
                f"KERNEL:fused_edge is not available for ALGORITHM "
                f"{cfg.algorithm!r}: the fused score+softmax+aggregation op "
                "serves the attention/edge-op families (GAT, GGCN); other "
                "families aggregate through OPTIM_KERNEL/PALLAS instead"
            )
        if cfg.optim_kernel or cfg.pallas_kernel:
            raise ValueError(
                "KERNEL:fused_edge and OPTIM_KERNEL/PALLAS select different "
                "routes for the same chain: choose one"
            )
    if cfg.kernel_tile and resident:
        raise ValueError(
            "KERNEL_TILE sets the bsp kernel's source tile; the ELL-level "
            "kernel (NTS_PALLAS_RESIDENT=1) has no tile to set"
        )
    if cfg.kernel_tile < 0:
        raise ValueError(f"KERNEL_TILE must be >= 0, got {cfg.kernel_tile}")
