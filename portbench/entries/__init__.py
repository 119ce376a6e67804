"""The program's entry points, one module each, found by the name a traffic
file gives under ``"entry"``.

A module defines ``Entry(config, traffic, seed, device)``, which makes the
cell's inputs and weights from ``seed`` on ``device`` and offers:

* ``classes`` — one label a request class (a shape), in the config's order;
* ``call(req)`` — the request through the program's entry, not waited for;
  it returns what ``check`` judges.  ``control(req)`` does the same with
  the reference at the precision below the configuration's, in the
  program's place (the calibration's control, never in a benchmark run);
* ``flops(req)`` — the algorithm's operations (``counts.py``);
* ``work(req)`` — the shapes each kernel family runs, for the rooflines;
* ``plan(req)`` — the program's planning calls a request makes;
* ``compile_set()`` — one fresh compile of the cell's program set;
* ``reset()`` — called as the window opens, after the warm-up (restarts
  a stateful entry's streams);
* ``free()`` — drop the program's state before the reference runs;
* ``check(samples)`` — the numbers compared, from the kept ``(req, out)``.

A request is ``(cls, slot)``: its class and its slot in the input pool.
"""
