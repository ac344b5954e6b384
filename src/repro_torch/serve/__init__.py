from .store import (MutableFingerprintStore, next_pow2,  # noqa: F401
                    validate_rows)
from .state import store_from_reference_arrays  # noqa: F401
