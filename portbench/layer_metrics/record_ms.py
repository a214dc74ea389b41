"""Mean host time of one fleet-wide telemetry record
(``FleetTelemetry.record_fleet``), from the benchmark's span around it."""


def read(rec):
    t = rec.spans.get("record", [])
    return 1e3 * sum(t) / len(t) if t else None
