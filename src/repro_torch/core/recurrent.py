"""Recurrent-model scheduling (paper Section 3.6).

A recurrent loop body (e.g. a GRU cell) is scheduled **three times**:

  * **priming**   — executes one instance from a cold state and leaves data
    buffers as close to the compute devices as possible (no output
    write-back);
  * **recursive** — scheduled from the priming iteration's residency with the
    loop carry rebound (outputs overwrite the corresponding inputs), so
    persistent data — weights above all — stays resident and the stream
    contains no redundant copies;
  * **finish**    — one final instance that places the outputs where the next
    instruction in the program needs them (their home memories).

At execution time a driver runs priming once, the recursive stream as many
times as needed, then the finish stream — exactly the paper's protocol.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .approach import Approach
from .executor import Machine
from .isel import Selection
from .scheduler import Schedule, Scheduler, SchedulerState
from .sysgraph import SystemGraph


@dataclass
class RecurrentSchedule:
    prime: Schedule
    recursive: Schedule
    finish: Schedule
    carry: dict[str, str]            # output buffer -> input buffer overwritten
    streamed: tuple[str, ...]        # per-step inputs (invalidate every step)

    def total_time(self, steps: int) -> float:
        if steps <= 1:
            return self.prime.makespan + self.finish.makespan
        return (self.prime.makespan
                + (steps - 2) * self.recursive.makespan
                + self.finish.makespan)

    def copy_counts(self) -> dict[str, int]:
        return {name: sum(1 for op in s.ops if op.kind in ("copy", "writeback"))
                for name, s in (("prime", self.prime),
                                ("recursive", self.recursive),
                                ("finish", self.finish))}


def _rebind_state(state: SchedulerState, selection: Selection,
                  carry: dict[str, str], streamed: tuple[str, ...],
                  homes: dict[str, str]):
    """Advance the scheduling state across the loop boundary: zero the
    accumulated temporaries, invalidate the per-step streamed inputs, and
    rename carry outputs onto the inputs they overwrite."""
    prog = selection.program

    def drop_all(buf: str):
        for k in [k for k in list(state.copies) if k[0] == buf]:
            for node in list(state.copies[k]):
                state.drop(node, k)
            state.copies.pop(k, None)
            state.version.pop(k, None)

    for b in prog.buffers:
        if b.name in homes and prog.buffer(b.name).temp:
            drop_all(b.name)         # temps restart from zero
    for name in streamed:
        drop_all(name)               # fresh content arrives at home
    for out_buf, in_buf in carry.items():
        drop_all(in_buf)
        for k in [k for k in list(state.copies) if k[0] == out_buf]:
            nk = (in_buf, k[1])
            state.copies[nk] = state.copies.pop(k)
            if k in state.version:
                state.version[nk] = state.version.pop(k)
            for (node, kk) in list(state.lru):
                if kk == k:
                    state.lru[(node, nk)] = state.lru.pop((node, kk))


def schedule_recurrent(selection: Selection, graph: SystemGraph,
                       carry: dict[str, str],
                       streamed: tuple[str, ...] = (),
                       approach: Approach | None = None) -> RecurrentSchedule:
    # priming iteration: cold start, keep data hot (no writeback)
    s_prime = Scheduler(selection, graph, approach)
    homes = s_prime.homes
    prime = s_prime.run_body(writeback=False)
    state = s_prime.state

    # recursive iteration: carry rebound, steady-state stream
    _rebind_state(state, selection, carry, streamed, homes)
    s_rec = Scheduler(selection, graph, approach, state=state)
    recursive = s_rec.run_body(writeback=False)

    # finish iteration: carry rebound again, outputs placed at home
    _rebind_state(s_rec.state, selection, carry, streamed, homes)
    s_fin = Scheduler(selection, graph, approach, state=s_rec.state)
    finish = s_fin.run_body(writeback=True)

    return RecurrentSchedule(prime, recursive, finish, dict(carry),
                             tuple(streamed))


# --------------------------------------------------------------------------- #
# Execution driver
# --------------------------------------------------------------------------- #


def execute_recurrent(rs: RecurrentSchedule, selection: Selection,
                      step_inputs: list[dict[str, np.ndarray]],
                      initial: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Run priming + (T-2) x recursive + finish with real data.

    ``step_inputs[t]`` holds the streamed buffers for step t; ``initial``
    holds weights and the initial carried state.
    """
    prog = selection.program
    steps = len(step_inputs)
    machine = Machine(rs.prime, {**initial, **step_inputs[0]})

    def rebind_machine(t: int):
        # zero temps
        for b in prog.buffers:
            if b.name in rs.prime.homes and prog.buffer(b.name).temp:
                machine.home_data[b.name][...] = 0.0
                for key in [k for k in list(machine.region_data)
                            if k[1] == b.name]:
                    del machine.region_data[key]
        # streamed inputs: new content lands at home
        for name in rs.streamed:
            machine.home_data[name] = np.asarray(
                step_inputs[t][name], dtype=np.float64).copy()
            for key in [k for k in list(machine.region_data) if k[1] == name]:
                del machine.region_data[key]
        # carry: outputs become inputs
        for out_buf, in_buf in rs.carry.items():
            machine.home_data[in_buf] = machine.home_data[out_buf].copy()
            for key in [k for k in list(machine.region_data) if k[1] == in_buf]:
                del machine.region_data[key]
            for key in [k for k in list(machine.region_data) if k[1] == out_buf]:
                node, _, bounds = key
                machine.region_data[(node, in_buf, bounds)] = \
                    machine.region_data.pop(key)
            machine.home_data[out_buf][...] = 0.0

    for op in rs.prime.ops:
        machine.run_op(op, selection)
    for t in range(1, steps - 1):
        rebind_machine(t)
        for op in rs.recursive.ops:
            machine.run_op(op, selection)
    if steps > 1:
        rebind_machine(steps - 1)
        for op in rs.finish.ops:
            machine.run_op(op, selection)
    return {name: machine.home_data[name].astype(np.float32)
            for name in prog.outputs}
