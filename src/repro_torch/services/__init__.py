from .admission import AdmissionController
from .gateway import ServingGateway

__all__ = ["AdmissionController", "ServingGateway"]
