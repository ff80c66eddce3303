from .es import ES

__all__ = ["ES"]
