"""Serving telemetry: the bounded histograms ``ServiceStats`` records into."""
