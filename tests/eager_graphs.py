"""A stand-in for ``train.graphs.StepGraphs`` on the CPU: the same keys, cap,
invalidation and counters, with the CUDA parts (the warm-up on a side
stream, the capture, the replay) replaced by the step run eagerly. ``log``
lists ``(what, signature)`` for each call: ``"warm"``, ``"capture"``,
``"replay"`` or ``"eager"`` (past the cap)."""

from __future__ import annotations

from news_recommendation_project_v2_torch.train.graphs import StepGraphs, signature


class EagerGraphs(StepGraphs):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.log: list[tuple[str, tuple]] = []

    def __call__(self, step, batch):
        def logged(b):
            if len(self.graphs) >= self.cap and signature(b) not in self.graphs:
                self.log.append(("eager", signature(b)))
            return step(b)

        return super().__call__(logged, batch)

    def _warm_up(self, step, batch):
        self.log.append(("warm", signature(batch)))
        return step(batch)

    def _capture(self, step, batch):
        self.log.append(("capture", signature(batch)))

        def replay(b):
            self.log.append(("replay", signature(b)))
            return step(b)

        return replay

    def kinds(self) -> list[str]:
        return [what for what, _ in self.log]
