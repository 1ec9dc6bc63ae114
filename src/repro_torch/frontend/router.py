"""Replica router: least-outstanding-tokens with session affinity, after
``repro.frontend.router``.

Sessions stick to the replica serving their live requests (their earlier
turns' KV pages and prefetch history live there); otherwise the arrival
lands on the replica with the fewest outstanding tokens, ties broken by the
lowest replica index so routing is fully deterministic.

Replica health: ``mark_down``/``mark_up`` take replicas out of / back into
the routing set. ``route`` never lands an arrival on a dead replica —
affinity bindings to a dead replica are rebound to the best live one (the
scheduler re-parks the session's live state there via the bit-exact
park/restore path, so the rebind costs no re-prefill).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Sequence, Set

from repro_torch.frontend.traces import ArrivalEvent


class ReplicaRouter:
    def __init__(self, n_replicas: int, affinity: bool = True):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.n = n_replicas
        self.affinity = affinity
        self._session_replica: Dict[int, int] = {}
        self._session_live: Dict[int, int] = {}
        self._dead: Set[int] = set()

    @property
    def dead(self) -> FrozenSet[int]:
        return frozenset(self._dead)

    def mark_down(self, replica: int) -> None:
        """Take a replica out of the routing set (failure detected)."""
        if not 0 <= replica < self.n:
            raise ValueError(f"no such replica {replica}")
        self._dead.add(replica)
        if len(self._dead) == self.n:
            self._dead.discard(replica)
            raise RuntimeError("cannot mark the last live replica down")

    def mark_up(self, replica: int) -> None:
        """Return a recovered replica to the routing set."""
        self._dead.discard(replica)

    def route(self, event: ArrivalEvent, outstanding: Sequence[int]) -> int:
        """Pick the replica for one arrival given per-replica outstanding
        token counts (binds the session; pair with ``note_done``)."""
        if len(outstanding) != self.n:
            raise ValueError("one outstanding count per replica")
        s = event.session
        if (
            self.affinity
            and s in self._session_replica
            and self._session_live.get(s, 0) > 0
            and self._session_replica[s] not in self._dead
        ):
            r = self._session_replica[s]
        else:
            live = [
                (o, i)
                for i, o in enumerate(outstanding)
                if i not in self._dead
            ]
            if not live:
                raise RuntimeError("no live replicas to route to")
            _, r = min(live)
            self._session_replica[s] = r
        self._session_live[s] = self._session_live.get(s, 0) + 1
        return r

    def note_done(self, event: ArrivalEvent) -> None:
        """A routed request finished (or was refused after routing): release
        its affinity hold. The sticky binding survives until the session has
        no live requests, then least-outstanding takes over again."""
        s = event.session
        self._session_live[s] = max(self._session_live.get(s, 0) - 1, 0)
