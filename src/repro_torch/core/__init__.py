"""Core of the port: traces, configuration and state, and the replay engine."""
