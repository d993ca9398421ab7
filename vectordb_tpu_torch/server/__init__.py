"""HTTP API layer.

Parity with reference src/server/mod.rs: ``AppState`` (store + metrics
behind a readers-writer lock), the ``start_flat`` and ``start_durable``
entry points, and the 9-endpoint router (src/server/routes.rs:102-120).
The route logic is framework-agnostic (``Api.handle`` takes
method/path/body and returns status + JSON) so tests drive it in-process
with no socket.
"""

from .app import AppState, serve, start_durable, start_flat  # noqa: F401
from .routes import Api  # noqa: F401


def test_api(metric=None, device="cuda"):
    """In-process (router, state) pair for tests — the analogue of the
    reference's test_app() fixture (src/server/routes.rs:445-453)."""
    from ..distance import DistanceMetric
    from ..store import VectorStore

    state = AppState(VectorStore.with_flat_index(
        metric or DistanceMetric.EUCLIDEAN, device=device))
    return Api(state), state
