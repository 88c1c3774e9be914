"""Mean host milliseconds a call of ``SketchServer.ingest`` (or, on a
pool, ``ingest_many``) takes in the window (the harness's span around each
call)."""


def read(obs):
    spans = obs.spans.get("ingest") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
