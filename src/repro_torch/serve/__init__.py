"""Serving: the engine and its generation loop, the slot scheduler, the
traffic server and the fault injectors."""
from .engine import Engine, ServeState, generate
from .faults import (AdmissionFault, CompositeFault, CorruptIndexFault,
                     FaultError, FaultInjector, InfLogitsFault,
                     NanLogitsFault, StepFault)
from .scheduler import (NO_DEADLINE, Completion, Request, Scheduler,
                        SlotTable)
from .server import (Arrival, Server, ServerReport, default_ladder,
                     poisson_arrivals, trace_arrivals)

__all__ = ["Engine", "ServeState", "generate", "Scheduler", "SlotTable",
           "Request", "Completion", "NO_DEADLINE", "Server", "ServerReport",
           "Arrival", "poisson_arrivals", "trace_arrivals", "default_ladder",
           "FaultError", "FaultInjector", "CompositeFault", "NanLogitsFault",
           "InfLogitsFault", "CorruptIndexFault", "AdmissionFault",
           "StepFault"]
