"""RL examples on the port: GRPO on fixed rollouts, and the full
rollout → reward → behavior log-probs → update loop."""
