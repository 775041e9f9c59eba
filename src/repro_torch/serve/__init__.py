"""Serving layer: ``GraphService`` (graph_service.py), the graph-query
service — concurrent single-query submissions dynamically micro-batched onto
one shared ``GraphSession`` — and its load generator (bench.py,
``python -m repro_torch.serve.bench``).

Observability and self-tuning live in ``repro_torch.obs`` (GraphPulse):
attach a ``MetricsHub`` via ``GraphService.attach_hub`` /
``GraphSession.attach_hub`` and steer the batching policy with
``AdaptiveServeController`` through ``GraphService.reconfigure``.
"""
from repro_torch.serve.graph_service import (AdmissionError, GraphService,
                                             MutationReport, ServiceClosed,
                                             ServiceConfig, ServiceStats,
                                             percentile)

__all__ = ["AdmissionError", "GraphService", "MutationReport",
           "ServiceClosed", "ServiceConfig", "ServiceStats", "percentile"]
