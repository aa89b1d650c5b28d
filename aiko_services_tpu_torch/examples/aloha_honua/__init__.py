# The hello-world actor (examples/aloha_honua/) on the port.
