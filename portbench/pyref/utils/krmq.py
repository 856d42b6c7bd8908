"""AVL tree augmented with subtree size and subtree-min ("range min
query") — semantics-exact replica of krmq.h as instantiated for RMQ
chaining (lchain.c:221-230).

Shape-exactness matters: krmq_rmq's result for tied priorities depends
on the tree's physical shape, which in turn depends on the exact AVL
insert/erase rebalancing sequences.  This implementation mirrors those
algorithms field for field.

Keys are (y:int, i:int) ordered lexicographically; priority is a float
(double) compared with strict <.
"""
from __future__ import annotations

from typing import Optional, Tuple


class RMQNode:
    __slots__ = ("y", "i", "pri", "p", "s", "balance", "size")

    def __init__(self, y: int, i: int, pri: float):
        self.y = y
        self.i = i
        self.pri = pri
        self.p = [None, None]  # type: ignore
        self.s = self
        self.balance = 0
        self.size = 1


def _cmp(a: Tuple[int, int], b: RMQNode) -> int:
    if a[0] != b.y:
        return -1 if a[0] < b.y else 1
    if a[1] != b.i:
        return -1 if a[1] < b.i else 1
    return 0


def _size(p: Optional[RMQNode]) -> int:
    return p.size if p is not None else 0


def _update_min(p: RMQNode, q: Optional[RMQNode], r: Optional[RMQNode]) -> None:
    p.s = p if (q is None or p.pri < q.s.pri) else q.s
    p.s = p.s if (r is None or p.s.pri < r.s.pri) else r.s


def _rotate1(p: RMQNode, dir_: int) -> RMQNode:
    opp = 1 - dir_
    q = p.p[opp]
    s = p.s
    size_p = p.size
    p.size -= q.size - _size(q.p[dir_])
    q.size = size_p
    _update_min(p, p.p[dir_], q.p[dir_])
    q.s = s
    p.p[opp] = q.p[dir_]
    q.p[dir_] = p
    return q


def _rotate2(p: RMQNode, dir_: int) -> RMQNode:
    opp = 1 - dir_
    q = p.p[opp]
    r = q.p[dir_]
    s = p.s
    size_x_dir = _size(r.p[dir_])
    r.size = p.size
    p.size -= q.size - size_x_dir
    q.size -= size_x_dir + 1
    _update_min(p, p.p[dir_], r.p[dir_])
    _update_min(q, q.p[opp], r.p[opp])
    r.s = s
    p.p[opp] = r.p[dir_]
    r.p[dir_] = p
    q.p[dir_] = r.p[opp]
    r.p[opp] = q
    b1 = 1 if dir_ == 0 else -1
    if r.balance == b1:
        q.balance, p.balance = 0, -b1
    elif r.balance == 0:
        q.balance = p.balance = 0
    else:
        q.balance, p.balance = b1, 0
    r.balance = 0
    return r


class RMQTree:
    def __init__(self):
        self.root: Optional[RMQNode] = None

    def size(self) -> int:
        return _size(self.root)

    def insert(self, x: RMQNode) -> RMQNode:
        """Insert node x; returns existing node if key present."""
        stack = []
        path = []
        bp, bq = self.root, None
        p, q = bp, None
        which = 0
        while p is not None:
            cmp = _cmp((x.y, x.i), p)
            if cmp == 0:
                return p
            if p.balance != 0:
                bq, bp = q, p
                stack = []
            which = 1 if cmp > 0 else 0
            stack.append(which)
            path.append(p)
            q, p = p, p.p[which]
        x.balance = 0
        x.size = 1
        x.p[0] = x.p[1] = None
        x.s = x
        if q is None:
            self.root = x
        else:
            q.p[which] = x
        if bp is None:
            return x
        for node in path:
            node.size += 1
        for i in range(len(path) - 1, -1, -1):
            _update_min(path[i], path[i].p[0], path[i].p[1])
            if path[i].s is not x:
                break
        # balance updates run from bp (deepest unbalanced ancestor) down to x
        st2 = []
        node = bp
        while node is not x:
            cmp = _cmp((x.y, x.i), node)
            w = 1 if cmp > 0 else 0
            st2.append(w)
            node = node.p[w]
        node = bp
        for w in st2:
            if w == 0:
                node.balance -= 1
            else:
                node.balance += 1
            node = node.p[w]
        if -2 < bp.balance < 2:
            return x
        which = 1 if bp.balance < 0 else 0
        b1 = 1 if which == 0 else -1
        q2 = bp.p[1 - which]
        if q2.balance == b1:
            r = _rotate1(bp, which)
            q2.balance = bp.balance = 0
        else:
            r = _rotate2(bp, which)
        if bq is None:
            self.root = r
        else:
            bq.p[0 if bp is bq.p[0] else 1] = r
        return x

    def find(self, key: Tuple[int, int]) -> Optional[RMQNode]:
        p = self.root
        while p is not None:
            cmp = _cmp(key, p)
            if cmp < 0:
                p = p.p[0]
            elif cmp > 0:
                p = p.p[1]
            else:
                return p
        return None

    def erase(self, x: RMQNode) -> Optional[RMQNode]:
        """Erase node with x's key; returns it or None."""
        if self.root is None:
            return None
        fake = RMQNode(0, 0, 0.0)
        fake.p[0] = self.root
        fake.p[1] = None
        path = []
        dirs = []
        cmp = -1
        p = fake
        while cmp != 0:
            which = 1 if cmp > 0 else 0
            dirs.append(which)
            path.append(p)
            p = p.p[which]
            if p is None:
                return None
            cmp = _cmp((x.y, x.i), p)
        d = len(path)
        for i in range(1, d):
            path[i].size -= 1
        if p.p[1] is None:
            path[d - 1].p[dirs[d - 1]] = p.p[0]
        else:
            q = p.p[1]
            if q.p[0] is None:
                q.p[0] = p.p[0]
                q.balance = p.balance
                path[d - 1].p[dirs[d - 1]] = q
                path.append(q)
                dirs.append(1)
                d += 1
                q.size = p.size - 1
            else:
                e = d
                path.append(None)  # placeholder at index e
                dirs.append(1)
                d += 1
                while True:
                    dirs.append(0)
                    path.append(q)
                    d += 1
                    r = q.p[0]
                    if r.p[0] is None:
                        break
                    q = r
                r.p[0] = p.p[0]
                q.p[0] = r.p[1]
                r.p[1] = p.p[1]
                r.balance = p.balance
                path[e - 1].p[dirs[e - 1]] = r
                path[e] = r
                dirs[e] = 1
                for i in range(e + 1, d):
                    path[i].size -= 1
                r.size = p.size - 1
        for i in range(d - 1, -1, -1):
            _update_min(path[i], path[i].p[0], path[i].p[1])
        while d - 1 > 0:
            d -= 1
            q = path[d]
            which = dirs[d]
            other = 1 - which
            b1, b2 = (1, 2) if which == 0 else (-1, -2)
            q.balance += b1
            if q.balance == b1:
                break
            elif q.balance == b2:
                r = q.p[other]
                if r.balance == -b1:
                    path[d - 1].p[dirs[d - 1]] = _rotate2(q, which)
                else:
                    path[d - 1].p[dirs[d - 1]] = _rotate1(q, which)
                    if r.balance == 0:
                        r.balance = -b1
                        q.balance = b1
                        break
                    else:
                        r.balance = q.balance = 0
        self.root = fake.p[0]
        return p

    def rmq(self, lo: Tuple[int, int], up: Tuple[int, int]) -> Optional[RMQNode]:
        """Min-priority element with key in closed interval [lo, up]
        (krmq_rmq, krmq.h:110-150)."""
        root = self.root
        if root is None:
            return None
        path0, pcmp0 = [], []
        p = root
        while p is not None:
            cmp = _cmp(lo, p)
            path0.append(p)
            pcmp0.append(cmp)
            if cmp < 0:
                p = p.p[0]
            elif cmp > 0:
                p = p.p[1]
            else:
                break
        path1, pcmp1 = [], []
        p = root
        while p is not None:
            cmp = _cmp(up, p)
            path1.append(p)
            pcmp1.append(cmp)
            if cmp < 0:
                p = p.p[0]
            elif cmp > 0:
                p = p.p[1]
            else:
                break
        i = 0
        while i < len(path0) and i < len(path1):
            if path0[i] is path1[i] and pcmp0[i] <= 0 and pcmp1[i] >= 0:
                break
            i += 1
        if i == len(path0) or i == len(path1):
            return None
        lca = i
        mn = path0[lca]
        for i in range(lca + 1, len(path0)):
            if pcmp0[i] <= 0:
                if path0[i].pri < mn.pri:
                    mn = path0[i]
                r = path0[i].p[1]
                if r is not None and r.s.pri < mn.pri:
                    mn = r.s
        for i in range(lca + 1, len(path1)):
            if pcmp1[i] >= 0:
                if path1[i].pri < mn.pri:
                    mn = path1[i]
                l = path1[i].p[0]
                if l is not None and l.s.pri < mn.pri:
                    mn = l.s
        return mn

    def interval(self, key: Tuple[int, int]):
        """(lower, upper): greatest node <= key, smallest node >= key."""
        p = self.root
        l = u = None
        while p is not None:
            cmp = _cmp(key, p)
            if cmp < 0:
                u = p
                p = p.p[0]
            elif cmp > 0:
                l = p
                p = p.p[1]
            else:
                l = u = p
                break
        return l, u

    def prev_of(self, node: RMQNode) -> Optional[RMQNode]:
        """In-order predecessor by key (krmq_itr_prev equivalent)."""
        key = (node.y, node.i)
        p = self.root
        best = None
        while p is not None:
            cmp = _cmp(key, p)
            if cmp <= 0:
                p = p.p[0]
            else:
                best = p
                p = p.p[1]
        return best
