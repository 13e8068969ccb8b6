"""Model configurations the fleet's LM workload prices."""
