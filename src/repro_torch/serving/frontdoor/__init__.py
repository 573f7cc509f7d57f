"""Async front door: streaming HTTP server, multi-replica router, and
the client that drives them (port of ``repro/serving/frontdoor``)."""

from repro_torch.serving.frontdoor.client import FrontDoorClient
from repro_torch.serving.frontdoor.replica import Replica, RequestHandle
from repro_torch.serving.frontdoor.router import POLICIES, Router
from repro_torch.serving.frontdoor.server import (FrontDoor, FrontDoorServer,
                                            HttpError)

__all__ = [
    "FrontDoor",
    "FrontDoorClient",
    "FrontDoorServer",
    "HttpError",
    "POLICIES",
    "Replica",
    "RequestHandle",
    "Router",
]
