"""The dry run's analysis: per-rank op counting, the roofline, the report."""
