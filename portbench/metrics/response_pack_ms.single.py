"""response_pack_ms.single: host ms a single fit spends building its
filter-response pack (the program's mbb.fit.response_pack spans, on its
own clock), per completed request, in the traced window. Point bands build
no pack: nothing to read there, nor in a program without the span."""

from portbench import program


def read(ctx):
    if ctx.cfg["fitter"] != "single":
        return None
    spans = program.recorded() or []
    ns = [s.end_ns - s.start_ns for s in spans
          if s.name == "mbb.fit.response_pack" and s.end_ns is not None]
    done = sum(1 for r in ctx.requests if r.error is None)
    if not ns or done == 0:
        return None
    return sum(ns) / done * 1e-6
