from repro_torch.track.trackers import (  # noqa: F401
    AGGREGATE, CLIENT_PASS, ENCODE, GNORM_KEY, PHASES, SERVER_UPDATE,
    CompositeTracker, CsvTracker, JsonlTracker, MemoryTracker, NullTracker,
    StdoutTracker, Tracker, TrackerSpec, composite, emitter, get_tracker,
    make_tracker, register_tracker, registered_trackers, resolve_opts,
    scope, with_grad_stats,
)
