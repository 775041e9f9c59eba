"""Serving layer: ``GraphService`` (graph_service.py), the graph-query
service — concurrent single-query submissions dynamically micro-batched onto
one shared ``GraphSession``."""
from repro_torch.serve.graph_service import (AdmissionError, GraphService,
                                             MutationReport, ServiceClosed,
                                             ServiceConfig, ServiceStats,
                                             percentile)

__all__ = ["AdmissionError", "GraphService", "MutationReport",
           "ServiceClosed", "ServiceConfig", "ServiceStats", "percentile"]
