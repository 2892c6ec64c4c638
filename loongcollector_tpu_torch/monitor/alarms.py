"""Leveled, aggregated alarms.

Reference: core/monitor/AlarmManager.h:137-188 — alarms keyed by AlarmType
with warning/error/critical levels, aggregated (count per key) between
flushes, shipped through internal pipelines (``monitor/self_monitor.py``,
``input_internal_alarms``).

The port's copy of the JAX package's ``monitor/alarms.py``: the same
taxonomy (wire names included), aggregation key, ``flush`` documents and
``empty``.  Two differences: a new aggregation key is not mirrored into a
flight recorder (the port has no ``prof/`` plane), and the manager keeps
lifetime totals by alarm type (``totals()``), which a flush does not
drain — ``--stats`` ``send.alarms`` reads them.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Dict, List, Optional, Tuple


class AlarmLevel(enum.IntEnum):
    WARNING = 0
    ERROR = 1
    CRITICAL = 2


class AlarmType(str, enum.Enum):
    """The reference's alarm taxonomy (core/monitor/AlarmManager.h:35-102),
    wire-name compatible so downstream alerting rules keyed on the alarm
    type string keep working, plus TPU-specific additions."""

    # config / control plane
    CONFIG_LOAD_FAIL = "CONFIG_LOAD_FAIL_ALARM"
    USER_CONFIG = "USER_CONFIG_ALARM"
    GLOBAL_CONFIG = "GLOBAL_CONFIG_ALARM"
    CONFIG_UPDATE = "CONFIG_UPDATE_ALARM"
    # loongtenant: a hot reload's new generation failed to init — the
    # manager ROLLED BACK to the previous generation, which keeps serving
    # (a bad fleet-wide YAML push degrades to "config not applied", never
    # to a collection outage)
    CONFIG_UPDATE_FAILED = "CONFIG_UPDATE_FAILED_ALARM"
    CATEGORY_CONFIG = "CATEGORY_CONFIG_ALARM"
    MULTI_CONFIG_MATCH = "MULTI_CONFIG_MATCH_ALARM"
    TOO_MANY_CONFIG = "TOO_MANY_CONFIG_ALARM"
    SAME_CONFIG = "SAME_CONFIG_ALARM"
    # file collection
    FILE_READ_FAIL = "READ_LOG_FAIL_ALARM"
    READ_LOG_DELAY = "READ_LOG_DELAY_ALARM"
    SKIP_READ_LOG = "SKIP_READ_LOG_ALARM"
    OPEN_LOGFILE_FAIL = "OPEN_LOGFILE_FAIL_ALARM"
    LOGFILE_PERMISSION = "LOGFILE_PERMINSSION_ALARM"
    LOGDIR_PERMISSION = "LOGDIR_PERMISSION_ALARM"
    LOG_TRUNCATE = "LOG_TRUNCATE_ALARM"
    SPLIT_LOG_FAIL = "SPLIT_LOG_FAIL_ALARM"
    FILE_READER_EXCEED = "FILE_READER_EXCEED_ALARM"
    OPEN_FILE_LIMIT = "OPEN_FILE_LIMIT_ALARM"
    DIR_EXCEED_LIMIT = "DIR_EXCEED_LIMIT_ALARM"
    STAT_LIMIT = "STAT_LIMIT_ALARM"
    MODIFY_FILE_EXCEED = "MODIFY_FILE_EXCEED_ALARM"
    INOTIFY_DIR_LIMIT = "INOTIFY_DIR_NUM_LIMIT_ALARM"
    REGISTER_INOTIFY_FAIL = "REGISTER_INOTIFY_FAIL_ALARM"
    INOTIFY_EVENT_OVERFLOW = "INOTIFY_EVENT_OVERFLOW_ALARM"
    READ_STOPPED_CONTAINER = "READ_STOPPED_CONTAINER_ALARM"
    INVALID_CONTAINER_PATH = "INVALID_CONTAINER_PATH_ALARM"
    # processing
    PARSE_LOG_FAIL = "PARSE_LOG_FAIL_ALARM"
    REGEX_MATCH = "REGEX_MATCH_ALARM"
    PARSE_TIME_FAIL = "PARSE_TIME_FAIL_ALARM"
    OUTDATED_LOG = "OUTDATED_LOG_ALARM"
    ENCODING_CONVERT = "ENCODING_CONVERT_ALARM"
    LOG_GROUP_PARSE_FAIL = "LOG_GROUP_PARSE_FAIL_ALARM"
    METRIC_GROUP_PARSE_FAIL = "METRIC_GROUP_PARSE_FAIL_ALARM"
    RELABEL_METRIC_FAIL = "RELABEL_METRIC_FAIL_ALARM"
    CAST_SENSITIVE_WORD = "CAST_SENSITIVE_WORD_ALARM"
    PROCESS_TOO_SLOW = "PROCESS_TOO_SLOW_ALARM"
    PROCESS_QUEUE_FULL = "PROCESS_QUEUE_FULL_ALARM"
    PROCESS_QUEUE_BUSY = "PROCESS_QUEUE_BUSY_ALARM"
    DROP_LOG = "DROP_LOG_ALARM"
    ENCRYPT_DECRYPT_FAIL = "ENCRYPT_DECRYPT_FAIL_ALARM"
    # sending
    SEND_FAIL = "SEND_DATA_FAIL_ALARM"
    SEND_QUOTA_EXCEED = "SEND_QUOTA_EXCEED_ALARM"
    SEND_COMPRESS_FAIL = "SEND_COMPRESS_FAIL_ALARM"
    COMPRESS_FAIL = "COMPRESS_FAIL_ALARM"
    SERIALIZE_FAIL = "SERIALIZE_FAIL_ALARM"
    SENDING_COSTS_TOO_MUCH_TIME = "SENDING_COSTS_TOO_MUCH_TIME_ALARM"
    LOG_GROUP_WAIT_TOO_LONG = "LOG_GROUP_WAIT_TOO_LONG_ALARM"
    DISCARD_DATA = "DISCARD_DATA_ALARM"
    DISCARD_SECONDARY = "DISCARD_SECONDARY_ALARM"
    SECONDARY_READ_WRITE = "SECONDARY_READ_WRITE_ALARM"
    SINK_CIRCUIT_OPEN = "SINK_CIRCUIT_OPEN_ALARM"
    # checkpoints / state
    CHECKPOINT_FAIL = "CHECKPOINT_ALARM"
    CHECKPOINT_V2 = "CHECKPOINT_V2_ALARM"
    EXACTLY_ONCE = "EXACTLY_ONCE_ALARM"
    LOAD_LOCAL_EVENT = "LOAD_LOCAL_EVENT_ALARM"
    # agent health
    CPU_LIMIT = "CPU_EXCEED_LIMIT_ALARM"
    MEM_LIMIT = "MEM_EXCEED_LIMIT_ALARM"
    AGENT_RESTART = "LOGTAIL_CRASH_ALARM"
    AGENT_CRASH_STACK = "LOGTAIL_CRASH_STACK_ALARM"
    INPUT_COLLECT_FAIL = "INPUT_COLLECT_ALARM"
    HOST_MONITOR = "HOST_MONITOR_ALARM"
    INNER_PROFILE = "INNER_PROFILE_ALARM"
    HOLD_ON_TOO_SLOW = "HOLD_ON_TOO_SLOW_ALARM"
    REGISTER_HANDLERS_TOO_SLOW = "REGISTER_HANDLERS_TOO_SLOW_ALARM"
    # TPU-specific
    DEVICE_PARSE_FALLBACK = "DEVICE_PARSE_FALLBACK_ALARM"
    DEVICE_BACKEND_DEGRADED = "DEVICE_BACKEND_DEGRADED_ALARM"
    MESH_SHARD_FALLBACK = "MESH_SHARD_FALLBACK_ALARM"
    # loongmesh: a chip lane's circuit opened — its shard respills to host
    # parsing while the rest of the mesh keeps running
    CHIP_LANE_OPEN = "CHIP_LANE_OPEN_ALARM"
    REGEX_TIER_DEMOTED = "REGEX_TIER_DEMOTED_ALARM"
    # loongstruct: a processor's sustained malformed-row rate pushed it
    # onto the counted per-row fallback path — correctness holds, but the
    # structural plane's throughput contract is broken for that pipeline
    PARSE_FALLBACK_DEGRADED = "PARSE_FALLBACK_DEGRADED_ALARM"
    # loongresident: a fused pipeline program demoted a chunk to the
    # per-stage dispatch path — answers identical, but that chunk paid N
    # round trips instead of one (docs/performance.md "Single-dispatch
    # pipeline fusion")
    FUSED_DEMOTED = "FUSED_DISPATCH_DEMOTED_ALARM"
    # loongledger: a quiesced conservation snapshot balanced to nonzero —
    # an event crossed into the agent and left without a ledgered exit
    CONSERVATION_RESIDUAL = "CONSERVATION_RESIDUAL_ALARM"
    # loongagg: the rollup key population hit its cardinality cap and
    # partials are being evicted (emitted early) — rollup windows for the
    # evicted keys are split, not lost
    AGG_WINDOW_EVICTION = "AGG_WINDOW_EVICTION_ALARM"
    # loongslo: a pipeline's freshness error budget is burning faster than
    # the multi-window multi-burn-rate policy tolerates — raised once per
    # episode with the stage-attributed latency-budget breakdown attached
    SLO_BURN_RATE = "SLO_BURN_RATE_ALARM"
    # loongxprof: a kernel family's jit compiles/minute crossed the storm
    # threshold (geometry churn — e.g. a flapping WidthAutoTuner bucket
    # forcing a fresh XLA compile per flap) — raised once per episode,
    # naming the churning family and geometry
    RECOMPILE_STORM = "RECOMPILE_STORM_ALARM"


class _AlarmRecord:
    __slots__ = ("type", "level", "message", "count", "first_time", "last_time",
                 "pipeline", "details")

    def __init__(self, typ: AlarmType, level: AlarmLevel, message: str,
                 pipeline: str):
        self.type = typ
        self.level = level
        self.message = message
        self.count = 0
        self.first_time = time.time()
        self.last_time = self.first_time
        self.pipeline = pipeline
        # structured payload (loongprof: flight-dump path, breach stack):
        # latest-wins across aggregation so a flush ships fresh pointers
        self.details: Dict[str, str] = {}


class AlarmManager:
    _instance: Optional["AlarmManager"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._records: Dict[Tuple[str, str, str], _AlarmRecord] = {}
        self._lock = threading.Lock()
        # alarms raised since construction (or reset), by AlarmType name
        self._totals: Dict[str, int] = {}

    @classmethod
    def instance(cls) -> "AlarmManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def send_alarm(self, typ: AlarmType, message: str,
                   level: AlarmLevel = AlarmLevel.WARNING,
                   pipeline: str = "",
                   details: Optional[Dict[str, str]] = None) -> None:
        key = (typ.value, message[:128], pipeline)
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                rec = _AlarmRecord(typ, level, message, pipeline)
                self._records[key] = rec
            rec.count += 1
            rec.last_time = time.time()
            self._totals[typ.name] = self._totals.get(typ.name, 0) + 1
            if details:
                rec.details.update({str(k): str(v)
                                    for k, v in details.items()})
    def flush(self) -> List[dict]:
        """Drain aggregated alarms as event dicts for the self-monitor
        pipeline."""
        with self._lock:
            records = list(self._records.values())
            self._records.clear()
        out = []
        for r in records:
            doc = {
                "alarm_type": r.type.value,
                "alarm_level": r.level.name.lower(),
                "alarm_message": r.message,
                "alarm_count": str(r.count),
                "pipeline": r.pipeline,
                "first_time": str(int(r.first_time)),
                "last_time": str(int(r.last_time)),
            }
            # structured details ride as extra content fields; the fixed
            # keys above always win a name collision
            for k, v in r.details.items():
                doc.setdefault(k, v)
            out.append(doc)
        return out

    def empty(self) -> bool:
        with self._lock:
            return not self._records

    def totals(self) -> Dict[str, int]:
        """Alarms raised since construction or ``reset``, by AlarmType
        name (``SEND_FAIL``, ...); flushes do not drain them."""
        with self._lock:
            return dict(self._totals)

    def reset(self) -> None:
        """Forget the aggregated records and the totals (a run's start)."""
        with self._lock:
            self._records.clear()
            self._totals.clear()
