"""Render graph: passes over named resources, run in dependency order.

Counterpart of `vision_tpu/pipelines/graph.py`: a pass declares the
resources it reads and writes; the graph sorts the passes topologically
and runs them. A pass is a callable (resources, ctx) -> dict of the
resources it produces. `default_graph` is the scene's "customized"
pipeline: integrate -> accumulate -> tonemap -> gamma.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass
class RenderPass:
    name: str
    fn: Callable                # (resources: dict, ctx: dict) -> dict
    inputs: tuple = ()
    outputs: tuple = ()


class RenderGraph:
    """Topologically executed pass graph."""

    def __init__(self):
        self.passes = []
        self._order = None

    def add_pass(self, name, fn, inputs=(), outputs=()):
        self.passes.append(RenderPass(name, fn, tuple(inputs), tuple(outputs)))
        self._order = None
        return self

    def compile(self):
        """Sort the passes by their resource dependencies (ready passes in
        the order they were added). Raises ValueError for a resource
        produced twice, and for a cycle."""
        produced = {}
        for p in self.passes:
            for o in p.outputs:
                if o in produced:
                    raise ValueError(f"resource '{o}' produced twice")
                produced[o] = p.name
        deps = {p.name: {produced[i] for i in p.inputs if i in produced}
                for p in self.passes}
        order = []
        ready = [p for p in self.passes if not deps[p.name]]
        done = set()
        while ready:
            p = ready.pop(0)
            order.append(p)
            done.add(p.name)
            for q in self.passes:
                if q.name not in done and q not in order and q not in ready:
                    if deps[q.name] <= done:
                        ready.append(q)
        if len(order) != len(self.passes):
            missing = [p.name for p in self.passes if p not in order]
            raise ValueError(
                f"render graph has a cycle or unresolved deps: {missing}")
        self._order = order
        return self

    def execute(self, initial_resources=None, ctx=None):
        """Run the passes in order over `initial_resources`; returns every
        resource. Raises KeyError for a pass whose input is missing or
        that did not produce one of its outputs."""
        if self._order is None:
            self.compile()
        res = dict(initial_resources or {})
        ctx = ctx or {}
        for p in self._order:
            missing = [i for i in p.inputs if i not in res]
            if missing:
                raise KeyError(f"pass '{p.name}' missing inputs {missing}")
            out = p.fn(res, ctx)
            for o in p.outputs:
                if o not in out:
                    raise KeyError(f"pass '{p.name}' did not produce '{o}'")
            res.update(out)
        return res


def default_graph(scene, camera, filt):
    """integrate (one sample per pixel, `pt.render_sample`) -> accumulate
    (into `accum_prev` when given) -> tonemapping -> gamma."""
    from ..integrator import pt
    from ..sensor import film

    def p_integrate(res, ctx):
        img, aovs = pt.render_sample(scene, camera, filt, ctx["frame_index"],
                                     max_depth=ctx.get("max_depth", 8))
        return {"radiance": img, "albedo": aovs["albedo"],
                "normal": aovs["normal"]}

    def p_accumulate(res, ctx):
        prev = res.get("accum_prev")
        if prev is None:
            return {"accum": res["radiance"]}
        return {"accum": film.accumulate(prev, res["radiance"],
                                         float(ctx["frame_index"]))}

    def p_tonemap(res, ctx):
        return {"tonemapped": film.tonemap(res["accum"],
                                           ctx.get("tone_mapper", "linear"),
                                           ctx.get("exposure", 1.0))}

    def p_gamma(res, ctx):
        return {"output": film.linear_to_srgb(res["tonemapped"])}

    g = RenderGraph()
    g.add_pass("integrate", p_integrate, (), ("radiance", "albedo", "normal"))
    g.add_pass("accumulate", p_accumulate, ("radiance",), ("accum",))
    g.add_pass("tonemapping", p_tonemap, ("accum",), ("tonemapped",))
    g.add_pass("gamma", p_gamma, ("tonemapped",), ("output",))
    return g.compile()
