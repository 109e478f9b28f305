from .server import WebDavServer

__all__ = ["WebDavServer"]
