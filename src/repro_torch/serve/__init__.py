from .scheduler import Engine, Request

__all__ = ["Engine", "Request"]
