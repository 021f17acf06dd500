"""One module per kind of traffic (a mix's ``"driver"`` key)."""
