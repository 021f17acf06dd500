"""The benchmark's general parts: cell lookup, environment, seeded inputs,
spans, trace reading and the yardstick."""
