"""One driver a kind of traffic, found by the name a traffic file's
``driver`` key gives: ``run(ctx) -> record``."""
