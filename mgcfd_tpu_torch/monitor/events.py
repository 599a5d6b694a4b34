"""The cost file's event selection: the PAPI-config analogue (mgcfd_tpu's
monitor/events.py).

The reference selects which hardware counters to record per run through
`-p papi.conf`, a text file of event names with '#' comments
(read_papi_config, io_enhanced.cpp:582-627; unknown events warn and are
skipped, papi_funcs.cpp:95-253). The port's events are rows of
KernelCosts.csv, one value per (solver function, level):
  CALLS                     calls in the timed run;
  MODEL_BYTES               bytes one call reads and writes once, and
  MODEL_OPERATIONS          its operations (monitor/costs.py, the model
                            behind chip_smoke.py's bounds);
  MEASURED_DEVICE_TIME_US   device microseconds and
  MEASURED_OCCURRENCES      device kernels (host ops on the CPU) in the
                            cycles --measure-ops profiled
                            (monitor/opstats.py); 0 unless it ran.
mgcfd_tpu's XLA_* and XPROF_* names are estimates of XLA's cost analysis
and xplane reads, quantities the port does not have: they warn and are
dropped like any unknown name.
"""
from __future__ import annotations

# event name -> key into KernelStats.cost_details (None: the call count)
SUPPORTED_EVENTS = {
    "CALLS": None,
    "MODEL_BYTES": "model_bytes",
    "MODEL_OPERATIONS": "model_operations",
    "MEASURED_DEVICE_TIME_US": "measured_device_time_us",
    "MEASURED_OCCURRENCES": "measured_occurrences",
}
MEASURED_EVENTS = ("MEASURED_DEVICE_TIME_US", "MEASURED_OCCURRENCES")
DEFAULT_EVENTS = ["MODEL_BYTES", "MODEL_OPERATIONS", "CALLS"]


def read_event_config(path: str) -> list[str]:
    """Parse an event-selection file: one event name per line, '#'
    comments and blank lines skipped; unsupported names warn and are
    dropped (the reference's failed-PAPI-event behaviour). An empty or
    unreadable file falls back to the defaults."""
    events = []
    try:
        with open(path) as f:
            for raw in f:
                name = raw.strip()
                if not name or name.startswith("#"):
                    continue
                if name not in SUPPORTED_EVENTS:
                    print(f"WARNING: event '{name}' is not supported "
                          f"(known: {', '.join(SUPPORTED_EVENTS)}); "
                          f"ignoring")
                    continue
                events.append(name)
    except OSError as e:
        print(f"WARNING: could not read event config {path}: {e}; "
              f"using defaults")
        return list(DEFAULT_EVENTS)
    return events or list(DEFAULT_EVENTS)


def selected_events(config) -> list[str]:
    if config.event_config_file:
        return read_event_config(config.event_config_file)
    return list(DEFAULT_EVENTS)


def event_rows(config, stats) -> list:
    """[(event name, {(function, level): value})] for write_costs_csv,
    from the run's cost details and call counts. When --measure-ops
    profiled the run, its measured rows are always included (asking for
    the measurement is the opt-in)."""
    names = selected_events(config)
    if stats.measured:
        names += [e for e in MEASURED_EVENTS if e not in names]
    rows = []
    for name in names:
        key = SUPPORTED_EVENTS[name]
        if key is None:
            rows.append((name, dict(stats.calls)))
        else:
            rows.append((name, {kl: d.get(key, 0) for kl, d in
                                stats.cost_details.items()}))
    return rows
