"""Structured, subsystem-scoped logging.

The port's own copy of the JAX package's logging.py, its loggers under
the "cilium_tpu_torch" root.

Behavioral analog of pkg/logging (logrus setup with
per-package `subsys` fields, logging/logfields.go's standard field
names, and pluggable sinks — syslog/logstash hooks in the reference,
a JSON-lines handler here):

  * `get_logger(subsys)` returns a logger carrying a `subsys` field,
    the way every reference package does
    `logging.DefaultLogger.WithField(logfields.LogSubsys, ...)`;
  * `with_fields(log, **fields)` returns an adapter that stamps
    structured fields on every record (logrus `WithFields`);
  * `setup(level=..., fmt="text"|"json", stream=...)` configures the
    root framework logger once (SetupLogging, logging.go) — "json"
    emits one JSON object per line with ts/level/subsys/msg plus any
    structured fields, the shape log collectors ingest;
  * standard field names mirror pkg/logging/logfields/logfields.go
    (endpoint id, identity, ipAddr, ...), so grep-ability matches the
    reference's operational docs.

Loggers nest under the "cilium_tpu_torch" root, so `setup()` governs the
whole framework without touching the process root logger (a library
must not hijack the host application's logging config).
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, MutableMapping, Optional, Tuple

ROOT = "cilium_tpu_torch"

# pkg/logging/logfields/logfields.go — the standard structured keys
SUBSYS = "subsys"
ENDPOINT_ID = "endpointID"
IDENTITY = "identity"
IP_ADDR = "ipAddr"
POLICY_REVISION = "policyRevision"
NODE_NAME = "nodeName"
L7_PROTO = "l7proto"
PORT = "port"
PROTOCOL = "protocol"


class _FieldsAdapter(logging.LoggerAdapter):
    """logrus-WithFields analog: merges bound fields into each record
    (they land in `record.fields` for the formatters below)."""

    def process(
        self, msg: str, kwargs: MutableMapping[str, Any]
    ) -> Tuple[str, MutableMapping[str, Any]]:
        extra = dict(kwargs.get("extra") or {})
        fields = dict(self.extra)
        fields.update(extra.pop("fields", {}))
        extra["fields"] = fields
        kwargs["extra"] = extra
        return msg, kwargs


def get_logger(subsys: str) -> logging.LoggerAdapter:
    """Per-subsystem logger with a `subsys` field (the reference's
    per-package `log = logging.DefaultLogger.WithField(subsys, ...)`)."""
    return _FieldsAdapter(
        logging.getLogger(f"{ROOT}.{subsys}"), {SUBSYS: subsys}
    )


def with_fields(
    log: logging.LoggerAdapter, **fields: Any
) -> logging.LoggerAdapter:
    """Bind additional structured fields (logrus WithFields)."""
    merged = dict(log.extra)
    merged.update(fields)
    return _FieldsAdapter(log.logger, merged)


class _TextFormatter(logging.Formatter):
    """level=x subsys=y msg="..." extra fields appended k=v."""

    def format(self, record: logging.LogRecord) -> str:
        fields: Dict[str, Any] = getattr(record, "fields", {})
        parts = [
            f"level={record.levelname.lower()}",
            f'msg="{record.getMessage()}"',
        ]
        for k in sorted(fields):
            parts.append(f"{k}={fields[k]}")
        return " ".join(parts)


class _JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        line = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "msg": record.getMessage(),
        }
        line.update(getattr(record, "fields", {}))
        if record.exc_info:
            line["exc"] = self.formatException(record.exc_info)
        return json.dumps(line)


def setup(
    level: int = logging.INFO,
    fmt: str = "text",
    stream=None,
) -> logging.Logger:
    """Configure the framework root logger (idempotent — replaces any
    handler a previous setup() installed).  Returns the root."""
    root = logging.getLogger(ROOT)
    root.setLevel(level)
    root.propagate = False
    for h in list(root.handlers):
        if getattr(h, "_cilium_tpu_torch_handler", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler._cilium_tpu_torch_handler = True
    handler.setFormatter(
        _JSONFormatter() if fmt == "json" else _TextFormatter()
    )
    root.addHandler(handler)
    return root


def set_level(level: int, subsys: Optional[str] = None) -> None:
    """Runtime level change, whole framework or one subsystem (the
    reference's debug toggles flip levels the same way)."""
    name = ROOT if subsys is None else f"{ROOT}.{subsys}"
    logging.getLogger(name).setLevel(level)
