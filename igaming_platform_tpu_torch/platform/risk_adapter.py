"""Risk gate adapters: how Wallet and Bonus reach the scoring engine.

The reference wires Wallet -> Risk over gRPC (wallet_service.go:262-279)
and Bonus -> Risk for abuse checks (bonus_engine.go:268-275). The port's
counterpart of ``igaming_platform_tpu/platform/risk_adapter.py`` gives both
deployment shapes:

- ``InProcessRiskGate``: the single binary, where the wallet calls the
  ``TorchScoringEngine`` directly (no serialization): each call is one
  ``score()``, one engine step on the engine's device;
- ``GrpcRiskGate``: across processes, a risk.v1 client, wire-compatible
  with either package's server or the reference's Go service. It encodes
  and decodes with the port's hand codec (``serve/risk_codec.py``) and
  dials through the port's own gRPC transport (``serve/grpc_wire.py``),
  the same here and on the card's machine, which has no grpcio. Its
  channel (and the channel's thread) is made with the gate; the first
  call dials.
"""

from __future__ import annotations

import numpy as np

from igaming_platform_tpu_torch.core.enums import ACTION_BLOCK, ACTION_REVIEW
from igaming_platform_tpu_torch.core.features import NUM_FEATURES, F
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine


class InProcessRiskGate:
    def __init__(self, engine: TorchScoringEngine):
        self.engine = engine

    def score_transaction(
        self, account_id: str, amount: int, tx_type: str,
        game_id: str = "", ip: str = "", device_id: str = "", fingerprint: str = "",
    ) -> tuple[int, str, list[str]]:
        resp = self.engine.score(ScoreRequest(
            account_id=account_id, amount=amount, tx_type=tx_type,
            game_id=game_id, ip=ip, device_id=device_id, fingerprint=fingerprint,
        ))
        return resp.score, resp.action, [r.value for r in resp.reason_codes]

    def check_bonus_abuse(self, account_id: str) -> bool:
        """Scalar abuse heuristic matching engine rule 7 semantics; the
        sequence model lives in serve/abuse.py."""
        row = np.zeros(NUM_FEATURES, dtype=np.float32)
        self.engine.features.fill_row(row, account_id, 0, "bet")
        return bool(row[F.BONUS_ONLY_PLAYER] > 0)


_ACTIONS = {ACTION_REVIEW: "review", ACTION_BLOCK: "block"}


class GrpcRiskGate:
    """risk.v1 ScoreTransaction client (the channel dials at the first
    call)."""

    def __init__(self, address: str, timeout: float = 5.0):
        from igaming_platform_tpu_torch.serve import grpc_wire
        from igaming_platform_tpu_torch.serve.grpc_server import make_risk_stub

        self.address = address
        self.timeout = timeout
        self.channel = grpc_wire.insecure_channel(address)
        self._stub = make_risk_stub(self.channel)

    def close(self) -> None:
        self.channel.close()

    def score_transaction(
        self, account_id: str, amount: int, tx_type: str,
        game_id: str = "", ip: str = "", device_id: str = "", fingerprint: str = "",
    ) -> tuple[int, str, list[str]]:
        from igaming_platform_tpu_torch.serve import risk_codec

        request = risk_codec.encode(risk_codec.SCORE_TRANSACTION_REQUEST, {
            "account_id": account_id, "amount": amount, "transaction_type": tx_type,
            "game_id": game_id, "ip_address": ip, "device_id": device_id,
            "fingerprint": fingerprint,
        })
        resp = risk_codec.decode(risk_codec.SCORE_TRANSACTION_RESPONSE,
                                 self._stub.ScoreTransaction(request,
                                                                      timeout=self.timeout))
        return resp["score"], _ACTIONS.get(resp["action"], "approve"), list(resp["reason_codes"])
