from .archive import NoveltyArchive
from .es import ES
from .iwes import IW_ES
from .nses import NS_ES, NSR_ES, NSRA_ES

__all__ = ["ES", "IW_ES", "NSRA_ES", "NSR_ES", "NS_ES", "NoveltyArchive"]
