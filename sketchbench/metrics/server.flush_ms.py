"""Mean host milliseconds a call of ``SketchServer.flush`` takes in the
window (the harness's span around each call)."""


def read(obs):
    spans = obs.spans.get("flush") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
