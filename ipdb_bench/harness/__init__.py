"""The harness: driver, instrumentation, traffic and the yardstick."""
