"""Each driver's tiny form for the CPU tests: ``tiny/<driver>.py``, found
by the workload's ``"driver"`` (``conftest.tiny_form``).  A form defines

* ``tiny_config(config) -> config`` and ``tiny_workload(workload) ->
  workload``: a configuration and a workload of the driver cut to a size
  the CPU runs in seconds (every driver that runs a configuration gives
  it the same ``tiny_config``);
* ``patch(monkeypatch)``: what the program needs besides to run there,
  applied when a test loads the driver (so it reaches only that driver's
  cells);
* ``SOUND``: what a sound untraced run of any of the driver's cells
  counts at that size with no time to spare: ``groups``, ``md_steps``,
  ``followed`` (what :func:`followed` names) and ``checks``, numbers of
  the run's ``checks`` with their exact values;
* ``followed(f)``: the names of what the comparison followed.
"""
