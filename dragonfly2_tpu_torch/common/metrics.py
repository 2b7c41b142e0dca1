"""Minimal prometheus-style metrics registry with text exposition.

Counterpart of ``dragonfly2_tpu/common/metrics.py``: counters, gauges and
histograms, exposed in Prometheus text format 0.0.4 (the manager's
``/metrics``). The registry's get-or-make returns the existing metric for
a same-kind, same-label name, so a reader finds the ``df_hbm_*`` series by
name.
"""

from __future__ import annotations

import threading
from typing import Iterable


class _Metric:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple[str, ...], float] = {}

    def labels(self, *labels: str) -> "_CounterChild":
        if len(labels) != len(self.label_names):
            raise ValueError(f"{self.name}: want {len(self.label_names)} labels")
        return _CounterChild(self, tuple(labels))

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def value(self, *labels: str) -> float:
        return self._values.get(tuple(labels), 0.0)

    def _samples(self) -> Iterable[tuple[tuple[str, ...], str, float]]:
        for k, v in list(self._values.items()):
            yield k, "", v



class _CounterChild:
    def __init__(self, parent: Counter, labels: tuple[str, ...]):
        self._p, self._l = parent, labels

    def inc(self, amount: float = 1.0) -> None:
        with self._p._lock:
            self._p._values[self._l] = self._p._values.get(self._l, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple[str, ...], float] = {}

    def labels(self, *labels: str) -> "_GaugeChild":
        if len(labels) != len(self.label_names):
            raise ValueError(f"{self.name}: want {len(self.label_names)} labels")
        return _GaugeChild(self, tuple(labels))

    def set(self, v: float) -> None:
        self.labels().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().inc(-amount)

    def value(self, *labels: str) -> float:
        return self._values.get(tuple(labels), 0.0)

    def _samples(self) -> Iterable[tuple[tuple[str, ...], str, float]]:
        for k, v in list(self._values.items()):
            yield k, "", v



class _GaugeChild:
    def __init__(self, parent: Gauge, labels: tuple[str, ...]):
        self._p, self._l = parent, labels

    def set(self, v: float) -> None:
        with self._p._lock:
            self._p._values[self._l] = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._p._lock:
            self._p._values[self._l] = self._p._values.get(self._l, 0.0) + amount


_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        # labels -> (bucket_counts, sum, count)
        self._values: dict[tuple[str, ...], tuple[list[int], float, int]] = {}

    def labels(self, *labels: str) -> "_HistChild":
        if len(labels) != len(self.label_names):
            raise ValueError(f"{self.name}: want {len(self.label_names)} labels")
        return _HistChild(self, tuple(labels))

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def snapshot(self, *labels: str) -> tuple[list[int], float, int]:
        return self._values.get(tuple(labels), ([0] * len(self.buckets), 0.0, 0))

    def _samples(self) -> Iterable[tuple[tuple[str, ...], str, float]]:
        for k, (counts, total, n) in list(self._values.items()):
            acc = 0
            for b, c in zip(self.buckets, counts):
                acc += c
                yield k + (str(b),), "_bucket", float(acc)
            yield k + ("+Inf",), "_bucket", float(n)
            yield k, "_sum", total
            yield k, "_count", float(n)


class _HistChild:
    def __init__(self, parent: Histogram, labels: tuple[str, ...]):
        self._p, self._l = parent, labels

    def observe(self, v: float) -> None:
        p = self._p
        with p._lock:
            counts, total, n = p._values.get(self._l, ([0] * len(p.buckets), 0.0, 0))
            for i, b in enumerate(p.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            p._values[self._l] = (counts, total + v, n + 1)


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Counter:
        return self._get_or_make(
            Counter, name, labels, lambda: Counter(name, help_, tuple(labels)))

    def gauge(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_make(
            Gauge, name, labels, lambda: Gauge(name, help_, tuple(labels)))

    def histogram(self, name: str, help_: str = "", labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(
            Histogram, name, labels, lambda: Histogram(name, help_, tuple(labels), buckets))

    def _get_or_make(self, cls, name, labels, factory=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory() if factory else cls(name, "", tuple(labels))
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as {m.kind}")
            elif m.label_names != tuple(labels):
                raise TypeError(f"metric {name} re-registered with labels "
                                f"{tuple(labels)} != {m.label_names}")
            return m

    def expose(self) -> str:
        """Prometheus text exposition (label values escaped per the format)."""

        def esc(val: str) -> str:
            return val.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

        with self._lock:
            metrics = list(self._metrics.values())
        out: list[str] = []
        for m in metrics:
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            extra = ("le",) if isinstance(m, Histogram) else ()
            for label_vals, suffix, v in m._samples():
                names = m.label_names + extra if suffix == "_bucket" else m.label_names
                if names and label_vals:
                    pairs = ",".join(f'{k}="{esc(str(val))}"'
                                     for k, val in zip(names, label_vals))
                    out.append(f"{m.name}{suffix}{{{pairs}}} {v}")
                else:
                    out.append(f"{m.name}{suffix} {v}")
        return "\n".join(out) + "\n"


REGISTRY = Registry()
