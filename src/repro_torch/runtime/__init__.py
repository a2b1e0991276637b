from .server import BatchServer, ServeResult

__all__ = ["BatchServer", "ServeResult"]
