from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
