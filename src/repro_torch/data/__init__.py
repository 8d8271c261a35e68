from .packing import pack_documents  # noqa: F401
from .pipeline import DataConfig, SyntheticTokenPipeline  # noqa: F401
