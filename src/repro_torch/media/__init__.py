"""Backing media of the tiers: device catalog and virtual-time queues, the
pinned staging ring, fault injection and the async migration pipeline."""
