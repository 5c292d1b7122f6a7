"""The systems the benchmark measures, one module (or package) each, named
by a configuration file's ``"system"`` key: ``load(spec)`` imports
``gpubench.systems.<spec["system"]>``.

``run.py``, ``window.py`` and ``control.py`` know nothing of what a system
builds; they reach it only through the names below.  A configuration of a
new architecture brings its system as new files: ``gpubench/systems/<name>.py``
or a package ``gpubench/systems/<name>/`` (its plain reference beside the
``__init__.py``), ``gpubench/configs/<config>.json`` with ``"system":
"<name>"``, ``gpubench/traffic/<mix>.json`` and entries in ``BENCHMARK.json``.

A configuration file always gives ``engine``: ``{"streams", "height",
"width", ...}``, the clip's shape (``traffic.pulse_clip``) and the streams
a call serves (``frames_per_s``), and ``limits``: ``{number: limit}``.

A system module gives:

- ``TRAFFIC_KEYS``: the traffic keys it reads beyond ``traffic.Traffic``'s
  fields, found in ``Traffic.params``; a key that neither knows is refused.
- ``make_inputs(spec, traffic, seed, workdir)``: what the benchmark makes
  from the seed and hands to both sides (nets, weights, files), with a
  ``close()`` that removes what it wrote.
- ``build_port(spec, inputs, device)``: ``(port, cfg)``, the system under
  test and its configuration object.
- ``start_state(port, cfg, traffic, device)``: the port's state before
  call 0; ``ref_start_state(ref, cfg, traffic, device)`` the reference's,
  built alike; ``same_start(ref_state, port_state)``: whether they agree.
- ``call(port, state, frames, ts)``: ``(state, out, host)``, one timed
  call: the port's step, then the readback of what a user reads (``host``,
  on the host).
- ``build_reference(spec, inputs, device)``: the plain reference, which
  imports nothing of the port; ``ref_step(ref, state, frames, ts)``:
  ``(state, out)``, one call of it.
- ``limits(spec, traffic)``: the numbers compared in this cell and their
  limits.
- ``judge(ref, checked)``: ``{number: gap}`` of one ``check.Checked`` call;
  ``judge_own(cfg, ref_state, ref_out, state, out)``: the numbers of the
  reference's own run from the start against the port's.
- ``control(spec, inputs, device)``: an object whose ``step(state, frames,
  ts)`` is the reference a step below the stated precisions, in the port's
  place; ``faults(ref, checked, traffic)``: the worst readings of a fault
  the port can have, planted in the checked calls, or None.
- ``net_flops(ref, spec, traffic, cfg)``: the operations of one call
  (``step_mfu``), or None.
- ``KERNELS``: ``{kernel: fn(batch, **shape) -> (operations, bytes)}``
  for the launches the configuration's ``kernels`` entry lists, and
  ``batch_of(net, cfg, traffic)``: the batch of a launch of ``net``
  (``counts.kernel_bound_s``).
- ``launch_counts()``: ``{kernel: launches so far}`` (the ``[kernels]``
  log line); ``tracked(state)``: what the ``[track]`` log line shows.
"""

from __future__ import annotations

import importlib


def load(spec: dict):
    """The system module a configuration file names."""
    return importlib.import_module(f"gpubench.systems.{spec['system']}")
