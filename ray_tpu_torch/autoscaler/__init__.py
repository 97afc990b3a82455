"""Autoscaling policy on the port: ``autoscaler.demand_scheduler``
(``serve_replica_demand``, the serving pool's replica count)."""
