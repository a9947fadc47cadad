"""graph.residual_fused_share: of the residual ``add`` layers that graph
lowering met (``synthesis.stage_a_plan``'s ``residual``), the share whose
group carries the ReLU after them (``residual_fused``), one dispatch where
there were two; nothing where no span says (a network without residual
adds, or a program that does not count them)."""


def read(run):
    spans = [s for s in run.spans
             if s.name == "synthesis.stage_a_plan" and s.attrs.get("residual")]
    if not spans:
        return None
    return (sum(s.attrs.get("residual_fused", 0) for s in spans)
            / sum(s.attrs["residual"] for s in spans))
