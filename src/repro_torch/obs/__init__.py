"""Shared telemetry reduction (``reduce.merge_counters``); the tracer and
its exports are not ported yet."""
