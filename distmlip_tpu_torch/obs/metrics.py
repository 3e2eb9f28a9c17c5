"""Live metrics: typed Counter/Gauge/Histogram + Prometheus exposition
(``distmlip_tpu/obs/metrics.py``).

The registry answers "what is tenant A's p99 *right now*" without
replaying a JSONL file: the serving instrumentation points (the same
places that emit ``StepRecord``\\ s) increment typed metrics, and the
current state is readable three ways — ``render()`` (Prometheus text
exposition, served by :class:`MetricsServer` on an optional stdlib
``http.server`` endpoint), ``snapshot()`` (a dict dumpable into the
bench/load-test JSON), and direct family reads in tests.

Hot-path cost: one dict lookup to find the family, one to find the
labeled child, one short ``threading.Lock`` hold per update (the lock is
per-family; counters and gauges hold it for a single float add). No torch,
no allocation after the first touch of a (family, labels) pair.

Histogram buckets are FIXED log-scale latency buckets (100 µs .. ~104 s,
x2 per rung) so percentile queries over the exposition are stable across
restarts and tenants — pass ``buckets=`` for non-latency quantities.

Label cardinality is BOUNDED: a registry-created family admits at most
``max_label_children`` distinct label-value sets (default 64); further
novel sets all route to one ``_other`` overflow child, and every routed
update increments ``distmlip_metrics_label_overflow_total{metric=...}``
— a tenant-id-per-request client degrades its own per-tenant resolution
instead of growing the registry (and every scrape) without bound.
"""

from __future__ import annotations

import bisect
import json
import threading

# fixed log-scale latency ladder: 100 µs doubling up to ~104 s. 21 rungs
# cover everything from a cache hit to a wedged-grant stall.
LATENCY_BUCKETS = tuple(1e-4 * 2 ** i for i in range(21))

_KINDS = ("counter", "gauge", "histogram")

# default per-family cap on distinct label-value sets; the overflow
# bucket label and the trip counter metric (exempt from its own cap)
DEFAULT_MAX_LABEL_CHILDREN = 64
OVERFLOW_LABEL = "_other"
_OVERFLOW_METRIC = "distmlip_metrics_label_overflow_total"


def _label_str(label_names, label_values) -> str:
    if not label_names:
        return ""
    inner = ",".join(f'{k}="{v}"'
                     for k, v in zip(label_names, label_values))
    return "{" + inner + "}"


class _Child:
    """One (family, label-values) time series."""

    __slots__ = ("family", "label_values", "value", "bucket_counts",
                 "sum", "count")

    def __init__(self, family, label_values):
        self.family = family
        self.label_values = label_values
        self.value = 0.0
        if family.kind == "histogram":
            self.bucket_counts = [0] * (len(family.buckets) + 1)  # +Inf
            self.sum = 0.0
            self.count = 0

    # --- counter / gauge ---

    def inc(self, n: float = 1.0) -> None:
        with self.family._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set(self, v: float) -> None:
        with self.family._lock:
            self.value = float(v)

    def get(self) -> float:
        with self.family._lock:
            return self.value

    # --- histogram ---

    def observe(self, v: float) -> None:
        fam = self.family
        i = bisect.bisect_left(fam.buckets, v)
        with fam._lock:
            self.bucket_counts[i] += 1
            self.sum += v
            self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket the
        q-th observation falls in) — the live-p99 read."""
        fam = self.family
        with fam._lock:
            total = self.count
            counts = list(self.bucket_counts)
        if total == 0:
            return 0.0
        rank = max(1, int(q * total + 0.5))
        seen = 0
        for i, n in enumerate(counts):
            seen += n
            if seen >= rank:
                return (fam.buckets[i] if i < len(fam.buckets)
                        else float("inf"))
        return float("inf")


class MetricFamily:
    """A named metric with a fixed label schema; children per value set."""

    def __init__(self, name: str, help: str, kind: str, label_names=(),
                 buckets=None, max_children=None, registry=None):
        if kind not in _KINDS:
            raise ValueError(f"kind {kind!r} not in {_KINDS}")
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = tuple(label_names)
        self.buckets = (tuple(buckets) if buckets is not None
                        else LATENCY_BUCKETS) if kind == "histogram" \
            else ()
        # None = unbounded (directly-constructed families, tests); the
        # registry passes its cap. The trip counter itself is exempt —
        # its cardinality is bounded by the number of families anyway,
        # and routing it to _other would recurse.
        self._max_children = (None if name == _OVERFLOW_METRIC
                              else max_children)
        self._registry = registry
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}
        self._default: _Child | None = None

    def labels(self, *values, **kv) -> _Child:
        if kv:
            values = tuple(str(kv[k]) for k in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values}")
        child = self._children.get(values)
        if child is not None:
            return child
        overflowed = False
        with self._lock:
            child = self._children.get(values)
            if child is None:
                if (self._max_children is not None and self.label_names
                        and len(self._children) >= self._max_children):
                    # cap tripped: route this (and every further novel)
                    # label set to the shared overflow child — each
                    # routed update counts one overflow below
                    overflowed = True
                    key = (OVERFLOW_LABEL,) * len(self.label_names)
                    child = self._children.get(key)
                    if child is None:
                        child = self._children[key] = _Child(self, key)
                else:
                    child = self._children[values] = _Child(self, values)
        if overflowed:
            # outside the family lock: the trip counter is ANOTHER
            # family, and nesting the two locks would order-invert
            # against a concurrent render()
            self._note_overflow()
        return child

    def _note_overflow(self) -> None:
        reg = self._registry
        if reg is None:
            return
        try:
            reg.counter(
                _OVERFLOW_METRIC,
                "Updates routed to the _other overflow child because a "
                "family hit its label-cardinality cap",
                labels=("metric",)).labels(metric=self.name).inc()
        except Exception:  # noqa: BLE001 - accounting must not raise
            pass

    def _unlabeled(self) -> _Child:
        if self._default is None:
            self._default = self.labels()
        return self._default

    # label-less convenience: the family itself acts as its single child
    def inc(self, n: float = 1.0) -> None:
        self._unlabeled().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._unlabeled().dec(n)

    def set(self, v: float) -> None:
        self._unlabeled().set(v)

    def get(self) -> float:
        return self._unlabeled().get()

    def observe(self, v: float) -> None:
        self._unlabeled().observe(v)

    def quantile(self, q: float) -> float:
        return self._unlabeled().quantile(q)

    # --- rendering ---

    def _render_into(self, out: list) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            items = sorted(self._children.items())
        for values, child in items:
            lbl = _label_str(self.label_names, values)
            if self.kind == "histogram":
                cum = 0
                for i, bound in enumerate(self.buckets):
                    cum += child.bucket_counts[i]
                    le = _label_str(self.label_names + ("le",),
                                    values + (f"{bound:g}",))
                    out.append(f"{self.name}_bucket{le} {cum}")
                cum += child.bucket_counts[-1]
                le = _label_str(self.label_names + ("le",),
                                values + ("+Inf",))
                out.append(f"{self.name}_bucket{le} {cum}")
                out.append(f"{self.name}_sum{lbl} {child.sum:g}")
                out.append(f"{self.name}_count{lbl} {child.count}")
            else:
                out.append(f"{self.name}{lbl} {child.value:g}")

    def _snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._children.items())
        samples = []
        for values, child in items:
            labels = dict(zip(self.label_names, values))
            if self.kind == "histogram":
                samples.append({
                    "labels": labels, "sum": child.sum,
                    "count": child.count,
                    "buckets": {f"{b:g}": c for b, c in
                                zip(self.buckets, child.bucket_counts)},
                    "overflow": child.bucket_counts[-1],
                })
            else:
                samples.append({"labels": labels, "value": child.value})
        return {"kind": self.kind, "help": self.help, "samples": samples}


class MetricsRegistry:
    """Get-or-create families by name; render / snapshot the whole set."""

    def __init__(self, max_label_children: int = DEFAULT_MAX_LABEL_CHILDREN):
        self._lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}
        self.max_label_children = max_label_children

    def _family(self, name, help, kind, labels, buckets=None):
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = MetricFamily(
                        name, help, kind, labels, buckets=buckets,
                        max_children=self.max_label_children,
                        registry=self)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"requested {kind}")
        return fam

    def counter(self, name: str, help: str = "",
                labels=()) -> MetricFamily:
        return self._family(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "", labels=()) -> MetricFamily:
        return self._family(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=None) -> MetricFamily:
        return self._family(name, help, "histogram", labels,
                            buckets=buckets)

    def get(self, name: str) -> MetricFamily | None:
        return self._families.get(name)

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        out: list[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            fam._render_into(out)
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        return {f.name: f._snapshot() for f in fams}

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)


def parse_exposition(text: str) -> dict[str, float]:
    """Parse Prometheus text exposition into ``{sample_line: value}``
    keyed by the full sample name incl. labels — the load-test scrape
    check compares these against the loadgen's own totals."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, value = line.rsplit(None, 1)
            out[key] = float(value)
        except ValueError:
            continue
    return out


class MetricsServer:
    """Optional stdlib HTTP endpoint serving ``GET /metrics``.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    Runs a daemon thread; ``close()`` shuts the listener down. No
    third-party dependency — ``http.server.ThreadingHTTPServer`` only.
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", start: bool = True):
        self.registry = registry
        self.host = host
        self._requested_port = int(port)
        self._httpd = None
        self._thread = None
        if start:
            self.start()

    def start(self) -> None:
        if self._httpd is not None:
            return
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = self.registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib naming
                if self.path.rstrip("/") in ("", "/metrics"):
                    body = registry.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *args):  # silence per-scrape stderr
                pass

        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="distmlip-metrics",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
