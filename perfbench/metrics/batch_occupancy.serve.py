"""Mean requests a solve batch of the service's worker lane
(`PackingService.stats()`)."""


def read(run):
    stats = run.rec.get("service_stats")
    return stats["batch_occupancy"]["mean"] if stats and stats["batches"] else None
