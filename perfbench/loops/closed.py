"""The loop driver ``closed``: each of the traffic's ``clients`` sends its
next request when its last one is answered, the requests in the pool's
sending order.  One client today: several would need threads, and the
Inferencer serves one call at a time."""


def run(window) -> None:
    clients = int(window.run.cell.traffic["clients"])
    if clients != 1:
        raise ValueError(f"the closed loop drives one client, not {clients}")
    k = 0
    while not window.closed():
        window.serve(window.pool.request(k, window.batch))
        k += 1
