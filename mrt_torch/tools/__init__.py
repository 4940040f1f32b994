"""Hardware probes of the port (``python -m mrt_torch.tools.<probe>``)."""
