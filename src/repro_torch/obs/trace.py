"""TraceRecorder — typed host-side event capture + Perfetto timeline export
(copied from ``repro.obs.trace``; pure Python).

The recorder is a bounded append-only buffer of schema-typed events
(:mod:`repro_torch.obs.schema`). Engines emit at boundaries where they ALREADY
compute the information host-side (the async pending-wire queue, the dist
schedule poll, the draws a step consumed) — recording never adds device
ops, which is what keeps a recording run bit-exact.

Export is a single JSON document that is BOTH things at once:

- ``traceEvents`` — a Chrome-trace/Perfetto timeline (load it at
  https://ui.perfetto.dev): one track per worker plus a trainer track,
  compute spans as complete events, message-mode wires as slices + flow
  arrows from the initiator's dispatch to the peer's arrival, faults and
  flow skips as instant markers;
- ``reproEvents`` — the raw typed events, the machine-readable record the
  CI schema gate and the report tool consume.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


class TraceRecorder:
    """Bounded typed-event buffer (see module docstring)."""

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = int(max_events)
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0     # events refused by the ring bound

    def emit(self, ev: str, t: float, step: int, worker: int = -1,
             **fields) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        e = {"ev": ev, "t": float(t), "step": int(step), "worker": int(worker)}
        e.update(fields)
        self.events.append(e)

    def __len__(self) -> int:
        return len(self.events)

    # ------------------------------------------------------------- perfetto
    def perfetto(self, num_workers: Optional[int] = None) -> Dict[str, Any]:
        """Render the typed events as a Chrome-trace document. Times map
        seconds -> microseconds; worker w lives on tid w+1, the trainer/fleet
        track on tid 0."""
        tev: List[Dict[str, Any]] = []
        pid = 1
        tids = {0}

        def us(t):
            return round(float(t) * 1e6, 3)

        def tid_of(worker):
            tid = int(worker) + 1 if worker is not None and worker >= 0 else 0
            tids.add(tid)
            return tid

        flow_id = 0
        for e in self.events:
            ev, t, w = e["ev"], e["t"], e.get("worker", -1)
            args = {k: v for k, v in e.items()
                    if k not in ("ev", "t") and v is not None}
            if ev == "compute":
                tev.append({"ph": "X", "name": "compute", "cat": "compute",
                            "pid": pid, "tid": tid_of(w), "ts": us(t),
                            "dur": max(us(e["dur"]), 1), "args": args})
            elif ev == "exchange":
                # in-window exchange: a thin slice on the initiator plus an
                # arrow to the peer at the same instant
                flow_id += 1
                tev.append({"ph": "X", "name": f"exchange→{e['peer']}",
                            "cat": "exchange", "pid": pid, "tid": tid_of(w),
                            "ts": us(t), "dur": 1, "args": args})
                tev.append({"ph": "s", "name": "wire", "cat": "exchange",
                            "id": flow_id, "pid": pid, "tid": tid_of(w),
                            "ts": us(t)})
                tev.append({"ph": "f", "bp": "e", "name": "wire",
                            "cat": "exchange", "id": flow_id, "pid": pid,
                            "tid": tid_of(e["peer"]), "ts": us(t) + 1})
            elif ev == "dispatch":
                # message-mode wire: slice spans dispatch -> expected arrival
                # on the initiator track; the arrow lands on the peer
                flow_id += 1
                dur = max(us(e["arrival"]) - us(t), 1)
                tev.append({"ph": "X", "name": f"wire→{e['peer']}",
                            "cat": "wire", "pid": pid, "tid": tid_of(w),
                            "ts": us(t), "dur": dur, "args": args})
                tev.append({"ph": "s", "name": "wire", "cat": "wire",
                            "id": flow_id, "pid": pid, "tid": tid_of(w),
                            "ts": us(t)})
                tev.append({"ph": "f", "bp": "e", "name": "wire",
                            "cat": "wire", "id": flow_id, "pid": pid,
                            "tid": tid_of(e["peer"]), "ts": us(e["arrival"])})
            elif ev == "apply":
                tev.append({"ph": "i", "name": f"apply←{e['worker']}",
                            "cat": "wire", "s": "t", "pid": pid,
                            "tid": tid_of(e["peer"]), "ts": us(t),
                            "args": args})
            elif ev == "outage":
                tev.append({"ph": "X", "name": "outage", "cat": "fault",
                            "pid": pid, "tid": 0, "ts": us(t),
                            "dur": max(us(e["until"]) - us(t), 1),
                            "args": args})
                tids.add(0)
            else:
                # faults, flow skips, chunks, timeouts/retries, serve events:
                # instant thread-scoped markers
                tev.append({"ph": "i", "name": ev, "cat": "marker", "s": "t",
                            "pid": pid, "tid": tid_of(w), "ts": us(t),
                            "args": args})
        if num_workers is not None:
            tids.update(range(1, int(num_workers) + 1))
        meta = [{"ph": "M", "name": "process_name", "pid": pid,
                 "args": {"name": "repro"}}]
        for tid in sorted(tids):
            name = "trainer" if tid == 0 else f"worker {tid - 1}"
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + tev,
                "displayTimeUnit": "ms",
                "reproEvents": self.events,
                "otherData": {"dropped_events": self.dropped}}
