"""The harness: what every cell shares (set-up, window, trace, verdict)."""
