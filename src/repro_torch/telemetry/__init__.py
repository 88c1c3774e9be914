"""repro_torch.telemetry — host-side counters of the port."""
