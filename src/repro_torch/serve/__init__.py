"""Multi-tenant QMC run service (paper §V as a long-lived engine).

The database-centric deployment's service form: ``QMCService`` (engine:
job queue, fair-share worker leases, live stats, extend/fork by run
key), ``QMCServiceServer`` (TCP framed-JSON front end), and
``ServiceClient`` (the ``qmc_client`` CLI's library).  Launchers live in
``repro.launch.qmc_serve`` / ``repro.launch.qmc_client``.
"""
from repro_torch.serve.client import ServiceClient, wait_for_server
from repro_torch.serve.engine import (CANCELLED, DONE, FAILED, FINAL_STATES,
                                QUEUED, RUNNING, QMCService,
                                default_builder, gaussian_builder)
from repro_torch.serve.protocol import ServiceError
from repro_torch.serve.scheduler import fair_shares
from repro_torch.serve.server import QMCServiceServer

__all__ = [
    'CANCELLED', 'DONE', 'FAILED', 'FINAL_STATES', 'QUEUED', 'RUNNING',
    'QMCService', 'QMCServiceServer', 'ServiceClient', 'ServiceError',
    'default_builder', 'fair_shares', 'gaussian_builder',
    'wait_for_server',
]
