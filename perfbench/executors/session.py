"""Requests through one ``GraphSession``, one in flight: a batch by
``run_batch``, a solo job by ``run``.  -> its values, [n] or [n, K]."""


def execute(session, req):
    if req.batch:
        session.run_batch(req.app, sources=req.sources,
                          max_iters=req.max_iters, **req.args)
        return session.last_batch_result.values
    kw = dict(req.args)
    if req.sources:
        kw["source"] = req.sources[0]
    return session.run(req.app, max_iters=req.max_iters, **kw).values
