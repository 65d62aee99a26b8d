"""repro_torch.obs — the observability layer: spans, software performance
counters, dispatch decision log, Chrome-trace export.

The software analogue of the paper's hardware performance-counter
methodology (Sec. V). Disabled by default; ``REPRO_OBS=1`` (or
`enable()`) turns recording on, ``REPRO_OBS_TRACE=path.json`` makes the
vision and serve CLIs export a Chrome trace-event artifact that
``python -m repro_torch.obs.report`` renders as MAC/µs-per-bit-width,
dispatch-summary, and top-span tables.

Import-light: neither this module, `obs.env`, `obs.trace` nor
`obs.report` imports torch at module level.
"""
from repro_torch.obs import env  # noqa: F401
from repro_torch.obs.trace import (TRACE_SCHEMA_VERSION,  # noqa: F401
                                   chrome_trace, counter, counter_values,
                                   disable, dispatch_event, dispatch_log,
                                   enable, enabled, enabled_scope, events,
                                   export_chrome_trace, export_if_configured,
                                   span, spans, summary, time_call)


def reset() -> None:
    """Drop every recorded event, generic counter, and op counter."""
    from repro_torch.obs import counters, trace
    trace.reset()
    counters.reset()
