# Hello-world actor: the port's copy of examples/aloha_honua/aloha_honua.py
# (reference: examples/aloha_honua/aloha_honua_0.py).
#
# Run (two terminals, or one with --self-test):
#   python -m aiko_services_tpu_torch registrar &
#   python -m aiko_services_tpu_torch.examples.aloha_honua.aloha_honua
#   # then publish "(aloha Pele)" to the actor's topic_in
#
# With --self-test everything (registrar, actor, caller) runs in one
# process on the in-memory broker: no external services needed.

# an example script: its console lines are its output
# graft: disable-file=lint-print

from __future__ import annotations

import sys

from aiko_services_tpu_torch import Actor, ProcessRuntime, Registrar

__all__ = ["AlohaHonua", "self_test", "main"]


class AlohaHonua(Actor):
    def __init__(self, runtime, name: str = "aloha_honua"):
        super().__init__(runtime, name, share={"greetings": 0})

    def aloha(self, name: str) -> None:
        count = self.ec_producer.get("greetings", 0) + 1
        self.ec_producer.update("greetings", count)
        self.logger.info("Aloha %s! (%d greetings)", name, count)
        print(f"Aloha {name}!")


def self_test(runtime) -> int:
    """Registrar, actor and caller on `runtime`: one greeting published
    to the actor's topic; returns the greetings its share counts."""
    Registrar(runtime)
    actor = AlohaHonua(runtime)
    runtime.event.run_until(lambda: runtime.registrar is not None,
                            timeout=6.0)
    runtime.publish(actor.topic_in, "(aloha Pele)")
    runtime.event.run_until(
        lambda: actor.ec_producer.get("greetings", 0) >= 1, timeout=6.0)
    return actor.ec_producer.get("greetings")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    runtime = ProcessRuntime(name="aloha_honua").initialize()
    if "--self-test" in argv:
        greetings = self_test(runtime)
        print("self-test ok:", greetings, "greeting(s)")
        runtime.terminate()
        return
    AlohaHonua(runtime)
    runtime.run()


if __name__ == "__main__":
    main()
