"""Plain references (a configuration's ``"reference"`` key names one)."""
