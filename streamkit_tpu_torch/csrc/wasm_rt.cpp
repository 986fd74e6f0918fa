// SPDX-License-Identifier: Apache-2.0
// Minimal WebAssembly (core MVP + sign-ext + bulk-memory subset) interpreter
// used as the sandboxed plugin runtime.
//
// Parity target: the reference hosts Component-Model WASM plugins via
// wasmtime with a 64 MiB store limit and per-call bounds
// (crates/plugin-wasm/src/lib.rs:40-57,319). No wasm runtime ships in this
// image, so this is a from-scratch interpreter with the same guardrails:
//   * hard linear-memory cap (64 MiB)
//   * per-call fuel budget (instruction count) instead of wall-clock timeout
//   * function imports only, dispatched to a registered host callback
//     (the component-model loader lowers host/WASI functions onto it;
//     classic pure-compute plugins import nothing)
//
// Exposed C API (consumed by streamkit_tpu_torch/plugins/{wasm,component}.py,
// which build this file with g++ through ops/_build.py):
//   skwasm_load(bytes, len, err, errlen)        -> instance* | NULL
//   skwasm_free(inst)
//   skwasm_call(inst, name, args, nargs, results, nresults, fuel, err, errlen)
//   skwasm_memory(inst, &size)                  -> uint8_t*
//   skwasm_memory_grow(inst, min_bytes, err, errlen)
//   skwasm_has_export(inst, name)               -> 0/1
//   skwasm_import_count/name/arity, skwasm_set_host(cb)  -> host imports

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <string>
#include <vector>
#include <unordered_map>

namespace {

constexpr size_t MEM_CAP = 64u * 1024u * 1024u;  // reference lib.rs:40-57
constexpr size_t PAGE = 65536;

struct Trap : std::exception {
    std::string msg;
    explicit Trap(std::string m) : msg(std::move(m)) {}
    const char* what() const noexcept override { return msg.c_str(); }
};

struct FuncType {
    std::vector<uint8_t> params, results;
};

struct Func {
    uint32_t type_idx = 0;
    std::vector<uint8_t> local_types;  // expanded
    const uint8_t* code = nullptr;     // start of body (after locals)
    const uint8_t* end = nullptr;      // one past the final `end` opcode
};

struct Global {
    uint8_t type;
    bool mut_;
    uint64_t value;
};

// Host-function import. The component-model loader (plugins/component.py)
// binds these to canonical-ABI lowered host functions (host.log,
// host.send-output, canon resource.new/rep/drop, WASI stubs); the classic
// pure-compute plugin path (plugins/wasm.py) loads modules with no imports
// and never registers a callback. Values cross as raw 64-bit bit patterns
// (f32/f64 as their bit representations), matching the interpreter stack.
typedef int (*skwasm_host_cb_t)(void* user, uint32_t import_idx,
                                const int64_t* args, uint32_t nargs,
                                int64_t* results, uint32_t nresults,
                                char* err, size_t errlen);

struct HostImport {
    std::string module, name;
    uint32_t type_idx = 0;
};

struct Module {
    std::vector<uint8_t> bytes;
    std::vector<FuncType> types;
    std::vector<HostImport> imports;  // function index space: imports first
    std::vector<Func> funcs;          // local functions (index - imports.size())
    std::vector<Global> globals;
    std::vector<uint32_t> table;  // funcref table
    std::unordered_map<std::string, uint32_t> func_exports;
    std::vector<uint8_t> memory;
    size_t mem_max = MEM_CAP;
    bool has_memory = false;
    skwasm_host_cb_t host_cb = nullptr;
    void* host_user = nullptr;
};

// ---------------------------------------------------------------------- leb
struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    uint8_t u8() {
        if (p >= end) throw Trap("eof");
        return *p++;
    }
    uint32_t u32() {
        uint32_t r = 0;
        int s = 0;
        while (true) {
            uint8_t b = u8();
            r |= uint32_t(b & 0x7f) << s;
            if (!(b & 0x80)) return r;
            s += 7;
            if (s > 35) throw Trap("leb too long");
        }
    }
    int32_t s32() {
        int64_t r = 0;
        int s = 0;
        while (true) {
            uint8_t b = u8();
            r |= int64_t(b & 0x7f) << s;
            s += 7;
            if (!(b & 0x80)) {
                if (s < 64 && (b & 0x40)) r |= -(int64_t(1) << s);
                return int32_t(r);
            }
            if (s > 35) throw Trap("leb too long");
        }
    }
    int64_t s64() {
        int64_t r = 0;
        int s = 0;
        while (true) {
            uint8_t b = u8();
            r |= int64_t(b & 0x7f) << s;
            s += 7;
            if (!(b & 0x80)) {
                if (s < 64 && (b & 0x40)) r |= -(int64_t(1) << s);
                return r;
            }
            if (s > 70) throw Trap("leb too long");
        }
    }
    void skip(size_t n) {
        if (size_t(end - p) < n) throw Trap("eof");
        p += n;
    }
    // bounds-checked little-endian reads for f32/f64 const immediates:
    // the memcpy must not happen before the range check (truncated bodies
    // would otherwise leak host-heap bytes into the sandbox).
    uint32_t f32bits() {
        if (size_t(end - p) < 4) throw Trap("eof");
        uint32_t v; memcpy(&v, p, 4); p += 4; return v;
    }
    uint64_t f64bits() {
        if (size_t(end - p) < 8) throw Trap("eof");
        uint64_t v; memcpy(&v, p, 8); p += 8; return v;
    }
    std::string name() {
        uint32_t n = u32();
        if (size_t(end - p) < n) throw Trap("eof");
        std::string s(reinterpret_cast<const char*>(p), n);
        p += n;
        return s;
    }
};

// skip an instruction for block-structure prescan / const exprs
void skip_const_expr(Reader& r) {
    while (true) {
        uint8_t op = r.u8();
        switch (op) {
            case 0x0b: return;                       // end
            case 0x41: r.s32(); break;               // i32.const
            case 0x42: r.s64(); break;               // i64.const
            case 0x43: r.skip(4); break;             // f32.const
            case 0x44: r.skip(8); break;             // f64.const
            case 0x23: r.u32(); break;               // global.get
            default: throw Trap("unsupported const expr");
        }
    }
}

uint64_t eval_const_expr(Reader& r, const std::vector<Global>& globals) {
    uint64_t v = 0;
    while (true) {
        uint8_t op = r.u8();
        switch (op) {
            case 0x0b: return v;
            case 0x41: v = uint64_t(uint32_t(r.s32())); break;
            case 0x42: v = uint64_t(r.s64()); break;
            case 0x43: v = r.f32bits(); break;
            case 0x44: v = r.f64bits(); break;
            case 0x23: v = globals.at(r.u32()).value; break;
            default: throw Trap("unsupported const expr");
        }
    }
}

// ------------------------------------------------------------------- loader
Module* load_module(const uint8_t* data, size_t len) {
    auto m = new Module();
    m->bytes.assign(data, data + len);
    Reader r{m->bytes.data(), m->bytes.data() + m->bytes.size()};
    if (len < 8 || memcmp(r.p, "\0asm", 4) != 0) throw Trap("bad magic");
    r.skip(4);
    uint32_t version;
    memcpy(&version, r.p, 4);
    r.skip(4);
    if (version != 1) throw Trap("unsupported wasm version");

    std::vector<uint32_t> func_type_idx;
    while (r.p < r.end) {
        uint8_t sec = r.u8();
        uint32_t size = r.u32();
        const uint8_t* sec_end = r.p + size;
        switch (sec) {
            case 1: {  // types
                uint32_t n = r.u32();
                for (uint32_t i = 0; i < n; i++) {
                    if (r.u8() != 0x60) throw Trap("bad functype");
                    FuncType ft;
                    uint32_t np = r.u32();
                    for (uint32_t j = 0; j < np; j++) ft.params.push_back(r.u8());
                    uint32_t nr = r.u32();
                    for (uint32_t j = 0; j < nr; j++) ft.results.push_back(r.u8());
                    m->types.push_back(std::move(ft));
                }
                break;
            }
            case 2: {  // imports — function imports only, host-dispatched
                uint32_t n = r.u32();
                for (uint32_t i = 0; i < n; i++) {
                    HostImport imp;
                    imp.module = r.name();
                    imp.name = r.name();
                    uint8_t kind = r.u8();
                    if (kind != 0x00)
                        throw Trap("only function imports supported (module '" +
                                   imp.module + "' field '" + imp.name + "')");
                    imp.type_idx = r.u32();
                    m->imports.push_back(std::move(imp));
                }
                break;
            }
            case 3: {  // functions
                uint32_t n = r.u32();
                for (uint32_t i = 0; i < n; i++) func_type_idx.push_back(r.u32());
                break;
            }
            case 4: {  // table
                uint32_t n = r.u32();
                for (uint32_t i = 0; i < n; i++) {
                    r.u8();  // elemtype
                    uint8_t flags = r.u8();
                    uint32_t min = r.u32();
                    if (flags & 1) r.u32();
                    m->table.assign(min, UINT32_MAX);
                }
                break;
            }
            case 5: {  // memory
                uint32_t n = r.u32();
                if (n > 1) throw Trap("multiple memories");
                if (n == 1) {
                    uint8_t flags = r.u8();
                    uint32_t min = r.u32();
                    uint64_t max_pages = MEM_CAP / PAGE;
                    if (flags & 1) max_pages = std::min<uint64_t>(r.u32(), max_pages);
                    if (uint64_t(min) * PAGE > MEM_CAP) throw Trap("memory min over cap");
                    m->memory.assign(size_t(min) * PAGE, 0);
                    m->mem_max = size_t(max_pages) * PAGE;
                    m->has_memory = true;
                }
                break;
            }
            case 6: {  // globals
                uint32_t n = r.u32();
                for (uint32_t i = 0; i < n; i++) {
                    Global g;
                    g.type = r.u8();
                    g.mut_ = r.u8() != 0;
                    g.value = eval_const_expr(r, m->globals);
                    m->globals.push_back(g);
                }
                break;
            }
            case 7: {  // exports
                uint32_t n = r.u32();
                for (uint32_t i = 0; i < n; i++) {
                    std::string name = r.name();
                    uint8_t kind = r.u8();
                    uint32_t idx = r.u32();
                    if (kind == 0) m->func_exports[name] = idx;
                }
                break;
            }
            case 9: {  // element segments (active only)
                uint32_t n = r.u32();
                for (uint32_t i = 0; i < n; i++) {
                    uint32_t flags = r.u32();
                    if (flags != 0) throw Trap("unsupported elem segment");
                    uint32_t off = uint32_t(eval_const_expr(r, m->globals));
                    uint32_t cnt = r.u32();
                    for (uint32_t j = 0; j < cnt; j++) {
                        uint32_t fi = r.u32();
                        if (off + j < m->table.size()) m->table[off + j] = fi;
                    }
                }
                break;
            }
            case 10: {  // code
                uint32_t n = r.u32();
                for (uint32_t i = 0; i < n; i++) {
                    uint32_t body_size = r.u32();
                    const uint8_t* body_end = r.p + body_size;
                    Func f;
                    f.type_idx = func_type_idx.at(i);
                    uint32_t nlocals = r.u32();
                    for (uint32_t j = 0; j < nlocals; j++) {
                        uint32_t cnt = r.u32();
                        uint8_t t = r.u8();
                        for (uint32_t k = 0; k < cnt; k++) f.local_types.push_back(t);
                    }
                    f.code = r.p;
                    f.end = body_end;
                    m->funcs.push_back(f);
                    r.p = body_end;
                }
                break;
            }
            case 11: {  // data segments (active)
                uint32_t n = r.u32();
                for (uint32_t i = 0; i < n; i++) {
                    uint32_t flags = r.u32();
                    if (flags == 1) {  // passive — skip payload
                        uint32_t cnt = r.u32();
                        r.skip(cnt);
                        continue;
                    }
                    if (flags == 2) r.u32();  // memidx
                    uint32_t off = uint32_t(eval_const_expr(r, m->globals));
                    uint32_t cnt = r.u32();
                    if (off + size_t(cnt) > m->memory.size()) throw Trap("data out of range");
                    if (size_t(r.end - r.p) < cnt) throw Trap("eof");
                    memcpy(m->memory.data() + off, r.p, cnt);
                    r.skip(cnt);
                }
                break;
            }
            default:
                r.p = sec_end;  // custom/unknown sections skipped
        }
        r.p = sec_end;
    }
    return m;
}

// ---------------------------------------------------------------- execution
struct Frame;

// Sandbox resource limits mirroring wasmtime's store limits (reference
// crates/plugin-wasm/src/lib.rs:40-57): bound both native-C-stack recursion
// (call_function recurses into exec) and the guest value stack, so hostile
// plugins trap instead of overflowing/exhausting the host.
constexpr uint32_t MAX_CALL_DEPTH = 1000;
constexpr size_t MAX_VALUE_STACK = 1u << 20;  // 1M values = 8 MiB

struct Interp {
    Module* m;
    std::vector<uint64_t> stack;
    uint64_t fuel;
    uint32_t depth = 0;

    explicit Interp(Module* mod, uint64_t f) : m(mod), fuel(f) {}

    void burn(uint64_t n = 1) {
        if (fuel < n) throw Trap("fuel exhausted (per-call budget)");
        fuel -= n;
    }

    uint64_t pop() {
        if (stack.empty()) throw Trap("stack underflow");
        uint64_t v = stack.back();
        stack.pop_back();
        return v;
    }
    void push(uint64_t v) {
        if (stack.size() >= MAX_VALUE_STACK) throw Trap("value stack limit exceeded");
        stack.push_back(v);
    }
    uint32_t pop32() { return uint32_t(pop()); }

    uint8_t* mem_at(uint64_t addr, size_t n) {
        if (!m->has_memory || addr + n > m->memory.size()) throw Trap("out-of-bounds memory access");
        return m->memory.data() + addr;
    }

    template <typename T>
    T load(uint32_t base, uint32_t off) {
        T v;
        memcpy(&v, mem_at(uint64_t(base) + off, sizeof(T)), sizeof(T));
        return v;
    }
    template <typename T>
    void store(uint32_t base, uint32_t off, T v) {
        memcpy(mem_at(uint64_t(base) + off, sizeof(T)), &v, sizeof(T));
    }

    void call_function(uint32_t fidx);
    void exec(const Func& f, std::vector<uint64_t>& locals);
};

struct Interp;
void exec_numeric_impl(Interp& I, uint8_t op, Reader& r);

// control-flow: we interpret structurally. A branch unwinds to the target
// label by replaying from recorded block entries.
struct Block {
    const uint8_t* pc_after;   // where to jump when breaking out (resolved lazily)
    const uint8_t* start;      // block/loop/if start (after blocktype)
    uint8_t opcode;            // 0x02 block / 0x03 loop / 0x04 if
    size_t stack_height;
    uint8_t arity;             // result count (0 or 1 for MVP blocktypes)
};

// find the matching end (and else) for the block starting at `p` (which
// points just after the blocktype byte). Counts nesting.
void find_block_ends(const uint8_t* p, const uint8_t* fend, const uint8_t** out_else,
                     const uint8_t** out_end) {
    int depth = 0;
    const uint8_t* els = nullptr;
    Reader r{p, fend};
    while (r.p < fend) {
        uint8_t op = r.u8();
        switch (op) {
            case 0x02: case 0x03: case 0x04: {
                int64_t bt = r.s64();
                (void)bt;
                depth++;
                break;
            }
            case 0x05:
                if (depth == 0 && !els) els = r.p;
                break;
            case 0x0b:
                if (depth == 0) {
                    *out_else = els;
                    *out_end = r.p;
                    return;
                }
                depth--;
                break;
            case 0x0c: case 0x0d: r.u32(); break;
            case 0x0e: {
                uint32_t n = r.u32();
                for (uint32_t i = 0; i <= n; i++) r.u32();
                break;
            }
            case 0x10: r.u32(); break;
            case 0x11: r.u32(); r.u32(); break;
            case 0x20: case 0x21: case 0x22: case 0x23: case 0x24: r.u32(); break;
            case 0x41: r.s32(); break;
            case 0x42: r.s64(); break;
            case 0x43: r.skip(4); break;
            case 0x44: r.skip(8); break;
            case 0x3f: case 0x40: r.u8(); break;
            case 0xfc: {
                uint32_t sub = r.u32();
                if (sub == 10) { r.u8(); r.u8(); }       // memory.copy
                else if (sub == 11) { r.u8(); }           // memory.fill
                else if (sub <= 7) {}                     // trunc_sat: no imm
                else throw Trap("unsupported 0xfc op in prescan");
                break;
            }
            default:
                if (op >= 0x28 && op <= 0x3e) { r.u32(); r.u32(); }  // mem imm
                // all numeric ops: no immediates
        }
    }
    throw Trap("unterminated block");
}

void Interp::call_function(uint32_t fidx) {
    size_t n_imp = m->imports.size();
    if (fidx >= n_imp + m->funcs.size()) throw Trap("bad function index");
    if (depth >= MAX_CALL_DEPTH) throw Trap("call stack exhausted");
    depth++;
    struct DepthGuard {
        uint32_t& d;
        ~DepthGuard() { d--; }
    } guard{depth};
    if (fidx < n_imp) {  // host import: dispatch through the registered cb
        const HostImport& imp = m->imports[fidx];
        if (!m->host_cb)
            throw Trap("no host binding for import " + imp.module + "." + imp.name);
        const FuncType& ft = m->types.at(imp.type_idx);
        burn(64);  // a host call is not free
        std::vector<int64_t> args(ft.params.size());
        for (size_t i = ft.params.size(); i-- > 0;) args[i] = int64_t(pop());
        std::vector<int64_t> results(ft.results.size(), 0);
        char err[256] = {0};
        int rc = m->host_cb(m->host_user, fidx, args.data(), uint32_t(args.size()),
                            results.data(), uint32_t(results.size()), err, sizeof err);
        if (rc != 0) throw Trap(err[0] ? err : "host import failed");
        for (auto v : results) push(uint64_t(v));
        return;
    }
    const Func& f = m->funcs[fidx - n_imp];
    const FuncType& ft = m->types.at(f.type_idx);
    std::vector<uint64_t> locals(ft.params.size() + f.local_types.size(), 0);
    for (size_t i = ft.params.size(); i-- > 0;) locals[i] = pop();
    size_t base = stack.size();
    exec(f, locals);
    // keep exactly `results` values produced by the body
    size_t want = ft.results.size();
    if (stack.size() < base + want) throw Trap("function produced too few results");
    if (stack.size() > base + want) {
        std::vector<uint64_t> res(stack.end() - want, stack.end());
        stack.resize(base);
        for (auto v : res) push(v);
    }
}

void Interp::exec(const Func& f, std::vector<uint64_t>& locals) {
    std::vector<Block> blocks;
    Reader r{f.code, f.end};

    auto do_branch = [&](uint32_t depth) {
        if (depth >= blocks.size()) {  // branch out of the function body
            r.p = f.end;
            blocks.clear();
            return;
        }
        Block& b = blocks[blocks.size() - 1 - depth];
        if (b.opcode == 0x03) {  // loop: jump back to start, keep the block
            // unwind stack to the loop entry height
            while (stack.size() > b.stack_height) stack.pop_back();
            blocks.resize(blocks.size() - depth);
            r.p = b.start;
        } else {
            // forward: keep arity results, unwind, jump past end
            std::vector<uint64_t> res;
            for (uint8_t i = 0; i < b.arity; i++) res.insert(res.begin(), pop());
            while (stack.size() > b.stack_height) stack.pop_back();
            for (auto v : res) push(v);
            if (!b.pc_after) {
                const uint8_t* els;
                const uint8_t* endp;
                find_block_ends(b.start, f.end, &els, &endp);
                b.pc_after = endp;
            }
            r.p = blocks[blocks.size() - 1 - depth].pc_after;
            blocks.resize(blocks.size() - 1 - depth);
        }
    };

    while (r.p < f.end) {
        burn();
        uint8_t op = r.u8();
        switch (op) {
            case 0x00: throw Trap("unreachable executed");
            case 0x01: break;  // nop
            case 0x02: case 0x03: {  // block / loop
                int64_t bt = r.s64();
                Block b;
                b.opcode = op;
                b.start = r.p;
                b.pc_after = nullptr;
                b.stack_height = stack.size();
                b.arity = (bt == -0x40 || op == 0x03) ? 0 : 1;
                blocks.push_back(b);
                break;
            }
            case 0x04: {  // if
                int64_t bt = r.s64();
                uint32_t cond = pop32();
                Block b;
                b.opcode = 0x02;  // behaves like block for branches
                b.start = r.p;
                b.pc_after = nullptr;
                b.stack_height = stack.size();
                b.arity = (bt == -0x40) ? 0 : 1;
                const uint8_t* els;
                const uint8_t* endp;
                find_block_ends(r.p, f.end, &els, &endp);
                b.pc_after = endp;
                blocks.push_back(b);
                if (!cond) {
                    r.p = els ? els : endp;
                    if (!els) blocks.pop_back();
                }
                break;
            }
            case 0x05: {  // else — reached after then-branch ran: skip to end
                Block b = blocks.back();
                blocks.pop_back();
                const uint8_t* els;
                const uint8_t* endp;
                if (b.pc_after) r.p = b.pc_after;
                else {
                    find_block_ends(b.start, f.end, &els, &endp);
                    r.p = endp;
                }
                break;
            }
            case 0x0b:  // end
                if (!blocks.empty()) blocks.pop_back();
                break;
            case 0x0c: do_branch(r.u32()); break;  // br
            case 0x0d: {  // br_if
                uint32_t depth = r.u32();
                if (pop32()) do_branch(depth);
                break;
            }
            case 0x0e: {  // br_table
                uint32_t n = r.u32();
                std::vector<uint32_t> targets(n);
                for (uint32_t i = 0; i < n; i++) targets[i] = r.u32();
                uint32_t def = r.u32();
                uint32_t idx = pop32();
                do_branch(idx < n ? targets[idx] : def);
                break;
            }
            case 0x0f:  // return
                r.p = f.end;
                blocks.clear();
                break;
            case 0x10: {  // call
                burn(8);
                call_function(r.u32());
                break;
            }
            case 0x11: {  // call_indirect
                burn(8);
                r.u32();  // type idx (unchecked)
                r.u32();  // table idx
                uint32_t elem = pop32();
                if (elem >= m->table.size() || m->table[elem] == UINT32_MAX)
                    throw Trap("bad call_indirect");
                call_function(m->table[elem]);
                break;
            }
            case 0x1a: pop(); break;  // drop
            case 0x1b: {              // select
                uint32_t c = pop32();
                uint64_t b = pop(), a = pop();
                push(c ? a : b);
                break;
            }
            case 0x20: push(locals.at(r.u32())); break;
            case 0x21: locals.at(r.u32()) = pop(); break;
            case 0x22: locals.at(r.u32()) = stack.back(); break;
            case 0x23: push(m->globals.at(r.u32()).value); break;
            case 0x24: m->globals.at(r.u32()).value = pop(); break;

#define MEMARG uint32_t align = r.u32(); (void)align; uint32_t off = r.u32()
            case 0x28: { MEMARG; push(uint32_t(load<uint32_t>(pop32(), off))); break; }
            case 0x29: { MEMARG; push(load<uint64_t>(pop32(), off)); break; }
            case 0x2a: { MEMARG; push(load<uint32_t>(pop32(), off)); break; }  // f32
            case 0x2b: { MEMARG; push(load<uint64_t>(pop32(), off)); break; }  // f64
            case 0x2c: { MEMARG; push(uint32_t(int32_t(load<int8_t>(pop32(), off)))); break; }
            case 0x2d: { MEMARG; push(uint32_t(load<uint8_t>(pop32(), off))); break; }
            case 0x2e: { MEMARG; push(uint32_t(int32_t(load<int16_t>(pop32(), off)))); break; }
            case 0x2f: { MEMARG; push(uint32_t(load<uint16_t>(pop32(), off))); break; }
            case 0x30: { MEMARG; push(uint64_t(int64_t(load<int8_t>(pop32(), off)))); break; }
            case 0x31: { MEMARG; push(uint64_t(load<uint8_t>(pop32(), off))); break; }
            case 0x32: { MEMARG; push(uint64_t(int64_t(load<int16_t>(pop32(), off)))); break; }
            case 0x33: { MEMARG; push(uint64_t(load<uint16_t>(pop32(), off))); break; }
            case 0x34: { MEMARG; push(uint64_t(int64_t(load<int32_t>(pop32(), off)))); break; }
            case 0x35: { MEMARG; push(uint64_t(load<uint32_t>(pop32(), off))); break; }
            case 0x36: { MEMARG; uint32_t v = pop32(); store<uint32_t>(pop32(), off, v); break; }
            case 0x37: { MEMARG; uint64_t v = pop(); store<uint64_t>(pop32(), off, v); break; }
            case 0x38: { MEMARG; uint32_t v = pop32(); store<uint32_t>(pop32(), off, v); break; }
            case 0x39: { MEMARG; uint64_t v = pop(); store<uint64_t>(pop32(), off, v); break; }
            case 0x3a: { MEMARG; uint8_t v = uint8_t(pop32()); store<uint8_t>(pop32(), off, v); break; }
            case 0x3b: { MEMARG; uint16_t v = uint16_t(pop32()); store<uint16_t>(pop32(), off, v); break; }
            case 0x3c: { MEMARG; uint8_t v = uint8_t(pop()); store<uint8_t>(pop32(), off, v); break; }
            case 0x3d: { MEMARG; uint16_t v = uint16_t(pop()); store<uint16_t>(pop32(), off, v); break; }
            case 0x3e: { MEMARG; uint32_t v = uint32_t(pop()); store<uint32_t>(pop32(), off, v); break; }
#undef MEMARG
            case 0x3f: r.u8(); push(uint32_t(m->memory.size() / PAGE)); break;
            case 0x40: {  // memory.grow
                r.u8();
                uint32_t delta = pop32();
                size_t cur = m->memory.size() / PAGE;
                size_t want = cur + delta;
                if (want * PAGE > m->mem_max || want * PAGE > MEM_CAP) {
                    push(uint32_t(-1));
                } else {
                    m->memory.resize(want * PAGE, 0);
                    push(uint32_t(cur));
                }
                break;
            }
            case 0x41: push(uint32_t(r.s32())); break;
            case 0x42: push(uint64_t(r.s64())); break;
            case 0x43: push(r.f32bits()); break;
            case 0x44: push(r.f64bits()); break;

            default:
                exec_numeric_impl(*this, op, r);
        }
    }
}

}  // namespace

namespace {

inline float as_f32(uint64_t v) { float f; uint32_t u = uint32_t(v); memcpy(&f, &u, 4); return f; }
inline uint64_t from_f32(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline double as_f64(uint64_t v) { double d; memcpy(&d, &v, 8); return d; }
inline uint64_t from_f64(double d) { uint64_t u; memcpy(&u, &d, 8); return u; }

void exec_numeric_impl(Interp& I, uint8_t op, Reader& r) {
    auto pop = [&]() { return I.pop(); };
    auto pop32 = [&]() { return I.pop32(); };
    auto push = [&](uint64_t v) { I.push(v); };
    auto push32 = [&](uint32_t v) { I.push(uint64_t(v)); };
    auto pushb = [&](bool b) { I.push(b ? 1 : 0); };

    switch (op) {
        case 0x45: pushb(pop32() == 0); break;                    // i32.eqz
        case 0x46: { uint32_t b = pop32(), a = pop32(); pushb(a == b); break; }
        case 0x47: { uint32_t b = pop32(), a = pop32(); pushb(a != b); break; }
        case 0x48: { int32_t b = pop32(), a = pop32(); pushb(a < b); break; }
        case 0x49: { uint32_t b = pop32(), a = pop32(); pushb(a < b); break; }
        case 0x4a: { int32_t b = pop32(), a = pop32(); pushb(a > b); break; }
        case 0x4b: { uint32_t b = pop32(), a = pop32(); pushb(a > b); break; }
        case 0x4c: { int32_t b = pop32(), a = pop32(); pushb(a <= b); break; }
        case 0x4d: { uint32_t b = pop32(), a = pop32(); pushb(a <= b); break; }
        case 0x4e: { int32_t b = pop32(), a = pop32(); pushb(a >= b); break; }
        case 0x4f: { uint32_t b = pop32(), a = pop32(); pushb(a >= b); break; }
        case 0x50: pushb(pop() == 0); break;                      // i64.eqz
        case 0x51: { uint64_t b = pop(), a = pop(); pushb(a == b); break; }
        case 0x52: { uint64_t b = pop(), a = pop(); pushb(a != b); break; }
        case 0x53: { int64_t b = pop(), a = pop(); pushb(a < b); break; }
        case 0x54: { uint64_t b = pop(), a = pop(); pushb(a < b); break; }
        case 0x55: { int64_t b = pop(), a = pop(); pushb(a > b); break; }
        case 0x56: { uint64_t b = pop(), a = pop(); pushb(a > b); break; }
        case 0x57: { int64_t b = pop(), a = pop(); pushb(a <= b); break; }
        case 0x58: { uint64_t b = pop(), a = pop(); pushb(a <= b); break; }
        case 0x59: { int64_t b = pop(), a = pop(); pushb(a >= b); break; }
        case 0x5a: { uint64_t b = pop(), a = pop(); pushb(a >= b); break; }
        case 0x5b: { float b = as_f32(pop()), a = as_f32(pop()); pushb(a == b); break; }
        case 0x5c: { float b = as_f32(pop()), a = as_f32(pop()); pushb(a != b); break; }
        case 0x5d: { float b = as_f32(pop()), a = as_f32(pop()); pushb(a < b); break; }
        case 0x5e: { float b = as_f32(pop()), a = as_f32(pop()); pushb(a > b); break; }
        case 0x5f: { float b = as_f32(pop()), a = as_f32(pop()); pushb(a <= b); break; }
        case 0x60: { float b = as_f32(pop()), a = as_f32(pop()); pushb(a >= b); break; }
        case 0x61: { double b = as_f64(pop()), a = as_f64(pop()); pushb(a == b); break; }
        case 0x62: { double b = as_f64(pop()), a = as_f64(pop()); pushb(a != b); break; }
        case 0x63: { double b = as_f64(pop()), a = as_f64(pop()); pushb(a < b); break; }
        case 0x64: { double b = as_f64(pop()), a = as_f64(pop()); pushb(a > b); break; }
        case 0x65: { double b = as_f64(pop()), a = as_f64(pop()); pushb(a <= b); break; }
        case 0x66: { double b = as_f64(pop()), a = as_f64(pop()); pushb(a >= b); break; }

        case 0x67: { uint32_t v = pop32(); push32(v ? uint32_t(__builtin_clz(v)) : 32); break; }
        case 0x68: { uint32_t v = pop32(); push32(v ? uint32_t(__builtin_ctz(v)) : 32); break; }
        case 0x69: push32(uint32_t(__builtin_popcount(pop32()))); break;
        case 0x6a: { uint32_t b = pop32(), a = pop32(); push32(a + b); break; }
        case 0x6b: { uint32_t b = pop32(), a = pop32(); push32(a - b); break; }
        case 0x6c: { uint32_t b = pop32(), a = pop32(); push32(a * b); break; }
        case 0x6d: { int32_t b = pop32(), a = pop32(); if (!b || (a == INT32_MIN && b == -1)) throw Trap("div"); push32(uint32_t(a / b)); break; }
        case 0x6e: { uint32_t b = pop32(), a = pop32(); if (!b) throw Trap("div"); push32(a / b); break; }
        case 0x6f: { int32_t b = pop32(), a = pop32(); if (!b) throw Trap("rem"); push32(uint32_t(b == -1 ? 0 : a % b)); break; }
        case 0x70: { uint32_t b = pop32(), a = pop32(); if (!b) throw Trap("rem"); push32(a % b); break; }
        case 0x71: { uint32_t b = pop32(), a = pop32(); push32(a & b); break; }
        case 0x72: { uint32_t b = pop32(), a = pop32(); push32(a | b); break; }
        case 0x73: { uint32_t b = pop32(), a = pop32(); push32(a ^ b); break; }
        case 0x74: { uint32_t b = pop32(), a = pop32(); push32(a << (b & 31)); break; }
        case 0x75: { uint32_t b = pop32(); int32_t a = pop32(); push32(uint32_t(a >> (b & 31))); break; }
        case 0x76: { uint32_t b = pop32(), a = pop32(); push32(a >> (b & 31)); break; }
        case 0x77: { uint32_t b = pop32() & 31, a = pop32(); push32((a << b) | (a >> ((32 - b) & 31))); break; }
        case 0x78: { uint32_t b = pop32() & 31, a = pop32(); push32((a >> b) | (a << ((32 - b) & 31))); break; }

        case 0x79: { uint64_t v = pop(); push(v ? uint64_t(__builtin_clzll(v)) : 64); break; }
        case 0x7a: { uint64_t v = pop(); push(v ? uint64_t(__builtin_ctzll(v)) : 64); break; }
        case 0x7b: push(uint64_t(__builtin_popcountll(pop()))); break;
        case 0x7c: { uint64_t b = pop(), a = pop(); push(a + b); break; }
        case 0x7d: { uint64_t b = pop(), a = pop(); push(a - b); break; }
        case 0x7e: { uint64_t b = pop(), a = pop(); push(a * b); break; }
        case 0x7f: { int64_t b = pop(), a = pop(); if (!b || (a == INT64_MIN && b == -1)) throw Trap("div"); push(uint64_t(a / b)); break; }
        case 0x80: { uint64_t b = pop(), a = pop(); if (!b) throw Trap("div"); push(a / b); break; }
        case 0x81: { int64_t b = pop(), a = pop(); if (!b) throw Trap("rem"); push(uint64_t(b == -1 ? 0 : a % b)); break; }
        case 0x82: { uint64_t b = pop(), a = pop(); if (!b) throw Trap("rem"); push(a % b); break; }
        case 0x83: { uint64_t b = pop(), a = pop(); push(a & b); break; }
        case 0x84: { uint64_t b = pop(), a = pop(); push(a | b); break; }
        case 0x85: { uint64_t b = pop(), a = pop(); push(a ^ b); break; }
        case 0x86: { uint64_t b = pop(), a = pop(); push(a << (b & 63)); break; }
        case 0x87: { uint64_t b = pop(); int64_t a = int64_t(pop()); push(uint64_t(a >> (b & 63))); break; }
        case 0x88: { uint64_t b = pop(), a = pop(); push(a >> (b & 63)); break; }
        case 0x89: { uint64_t b = pop() & 63, a = pop(); push((a << b) | (a >> ((64 - b) & 63))); break; }
        case 0x8a: { uint64_t b = pop() & 63, a = pop(); push((a >> b) | (a << ((64 - b) & 63))); break; }

        case 0x8b: push(from_f32(fabsf(as_f32(pop())))); break;
        case 0x8c: push(from_f32(-as_f32(pop()))); break;
        case 0x8d: push(from_f32(ceilf(as_f32(pop())))); break;
        case 0x8e: push(from_f32(floorf(as_f32(pop())))); break;
        case 0x8f: push(from_f32(truncf(as_f32(pop())))); break;
        case 0x90: push(from_f32(nearbyintf(as_f32(pop())))); break;
        case 0x91: push(from_f32(sqrtf(as_f32(pop())))); break;
        case 0x92: { float b = as_f32(pop()), a = as_f32(pop()); push(from_f32(a + b)); break; }
        case 0x93: { float b = as_f32(pop()), a = as_f32(pop()); push(from_f32(a - b)); break; }
        case 0x94: { float b = as_f32(pop()), a = as_f32(pop()); push(from_f32(a * b)); break; }
        case 0x95: { float b = as_f32(pop()), a = as_f32(pop()); push(from_f32(a / b)); break; }
        case 0x96: { float b = as_f32(pop()), a = as_f32(pop()); push(from_f32(fminf(a, b))); break; }
        case 0x97: { float b = as_f32(pop()), a = as_f32(pop()); push(from_f32(fmaxf(a, b))); break; }
        case 0x98: { float b = as_f32(pop()), a = as_f32(pop()); push(from_f32(copysignf(a, b))); break; }

        case 0x99: push(from_f64(fabs(as_f64(pop())))); break;
        case 0x9a: push(from_f64(-as_f64(pop()))); break;
        case 0x9b: push(from_f64(ceil(as_f64(pop())))); break;
        case 0x9c: push(from_f64(floor(as_f64(pop())))); break;
        case 0x9d: push(from_f64(trunc(as_f64(pop())))); break;
        case 0x9e: push(from_f64(nearbyint(as_f64(pop())))); break;
        case 0x9f: push(from_f64(sqrt(as_f64(pop())))); break;
        case 0xa0: { double b = as_f64(pop()), a = as_f64(pop()); push(from_f64(a + b)); break; }
        case 0xa1: { double b = as_f64(pop()), a = as_f64(pop()); push(from_f64(a - b)); break; }
        case 0xa2: { double b = as_f64(pop()), a = as_f64(pop()); push(from_f64(a * b)); break; }
        case 0xa3: { double b = as_f64(pop()), a = as_f64(pop()); push(from_f64(a / b)); break; }
        case 0xa4: { double b = as_f64(pop()), a = as_f64(pop()); push(from_f64(fmin(a, b))); break; }
        case 0xa5: { double b = as_f64(pop()), a = as_f64(pop()); push(from_f64(fmax(a, b))); break; }
        case 0xa6: { double b = as_f64(pop()), a = as_f64(pop()); push(from_f64(copysign(a, b))); break; }

        case 0xa7: push32(uint32_t(pop())); break;                       // i32.wrap_i64
        case 0xa8: { float v = as_f32(pop()); if (!(v > -2147483649.0f && v < 2147483648.0f)) throw Trap("trunc"); push32(uint32_t(int32_t(v))); break; }
        case 0xa9: { float v = as_f32(pop()); if (!(v > -1.0f && v < 4294967296.0f)) throw Trap("trunc"); push32(uint32_t(v)); break; }
        case 0xaa: { double v = as_f64(pop()); if (!(v > -2147483649.0 && v < 2147483648.0)) throw Trap("trunc"); push32(uint32_t(int32_t(v))); break; }
        case 0xab: { double v = as_f64(pop()); if (!(v > -1.0 && v < 4294967296.0)) throw Trap("trunc"); push32(uint32_t(v)); break; }
        case 0xac: push(uint64_t(int64_t(int32_t(pop32())))); break;     // i64.extend_i32_s
        case 0xad: push(uint64_t(pop32())); break;                       // i64.extend_i32_u
        case 0xae: { float v = as_f32(pop()); push(uint64_t(int64_t(v))); break; }
        case 0xaf: { float v = as_f32(pop()); push(uint64_t(v)); break; }
        case 0xb0: { double v = as_f64(pop()); push(uint64_t(int64_t(v))); break; }
        case 0xb1: { double v = as_f64(pop()); push(uint64_t(v)); break; }
        case 0xb2: push(from_f32(float(int32_t(pop32())))); break;
        case 0xb3: push(from_f32(float(pop32()))); break;
        case 0xb4: push(from_f32(float(int64_t(pop())))); break;
        case 0xb5: push(from_f32(float(pop()))); break;
        case 0xb6: push(from_f32(float(as_f64(pop())))); break;          // f32.demote
        case 0xb7: push(from_f64(double(int32_t(pop32())))); break;
        case 0xb8: push(from_f64(double(pop32()))); break;
        case 0xb9: push(from_f64(double(int64_t(pop())))); break;
        case 0xba: push(from_f64(double(pop()))); break;
        case 0xbb: push(from_f64(double(as_f32(pop())))); break;         // f64.promote
        case 0xbc: push32(pop32()); break;                               // i32.reinterpret_f32
        case 0xbd: push(pop()); break;                                   // i64.reinterpret_f64
        case 0xbe: push32(pop32()); break;                               // f32.reinterpret_i32
        case 0xbf: push(pop()); break;                                   // f64.reinterpret_i64

        case 0xc0: push32(uint32_t(int32_t(int8_t(pop32())))); break;    // i32.extend8_s
        case 0xc1: push32(uint32_t(int32_t(int16_t(pop32())))); break;
        case 0xc2: push(uint64_t(int64_t(int8_t(pop())))); break;
        case 0xc3: push(uint64_t(int64_t(int16_t(pop())))); break;
        case 0xc4: push(uint64_t(int64_t(int32_t(pop())))); break;

        case 0xfc: {  // saturating trunc + bulk memory
            uint32_t sub = r.u32();
            switch (sub) {
                case 0: { float v = as_f32(pop()); push32(uint32_t(int32_t(std::fmax(-2147483648.0f, std::fmin(2147483520.0f, v))))); break; }
                case 1: { float v = as_f32(pop()); push32(uint32_t(std::fmax(0.0f, std::fmin(4294967040.0f, v)))); break; }
                case 2: { double v = as_f64(pop()); push32(uint32_t(int32_t(std::fmax(-2147483648.0, std::fmin(2147483647.0, v))))); break; }
                case 3: { double v = as_f64(pop()); push32(uint32_t(std::fmax(0.0, std::fmin(4294967295.0, v)))); break; }
                case 10: {  // memory.copy
                    r.u8(); r.u8();
                    uint32_t n = pop32(), src = pop32(), dst = pop32();
                    memmove(I.mem_at(dst, n), I.mem_at(src, n), n);
                    I.burn(n / 8);
                    break;
                }
                case 11: {  // memory.fill
                    r.u8();
                    uint32_t n = pop32(), val = pop32(), dst = pop32();
                    memset(I.mem_at(dst, n), int(val & 0xff), n);
                    I.burn(n / 8);
                    break;
                }
                default: throw Trap("unsupported 0xfc opcode");
            }
            break;
        }
        default: {
            char buf[64];
            snprintf(buf, sizeof buf, "unsupported opcode 0x%02x", op);
            throw Trap(buf);
        }
    }
}

}  // namespace

// ------------------------------------------------------------------- C API

extern "C" {

void* skwasm_load(const uint8_t* bytes, size_t len, char* err, size_t errlen) {
    try {
        return load_module(bytes, len);
    } catch (const std::exception& e) {
        if (err && errlen) snprintf(err, errlen, "%s", e.what());
        return nullptr;
    }
}

void skwasm_free(void* inst) { delete static_cast<Module*>(inst); }

// -------- host imports (component-model loader binds these from Python) ----

int skwasm_import_count(void* inst) {
    return int(static_cast<Module*>(inst)->imports.size());
}

int skwasm_import_name(void* inst, int i, char* module, size_t mlen,
                       char* name, size_t nlen) {
    auto* m = static_cast<Module*>(inst);
    if (i < 0 || size_t(i) >= m->imports.size()) return -1;
    if (module && mlen) snprintf(module, mlen, "%s", m->imports[i].module.c_str());
    if (name && nlen) snprintf(name, nlen, "%s", m->imports[i].name.c_str());
    return 0;
}

int skwasm_import_arity(void* inst, int i, int* nparams, int* nresults) {
    auto* m = static_cast<Module*>(inst);
    if (i < 0 || size_t(i) >= m->imports.size()) return -1;
    const FuncType& ft = m->types.at(m->imports[i].type_idx);
    if (nparams) *nparams = int(ft.params.size());
    if (nresults) *nresults = int(ft.results.size());
    return 0;
}

void skwasm_set_host(void* inst, skwasm_host_cb_t cb, void* user) {
    auto* m = static_cast<Module*>(inst);
    m->host_cb = cb;
    m->host_user = user;
}

int skwasm_has_export(void* inst, const char* name) {
    auto* m = static_cast<Module*>(inst);
    return m->func_exports.count(name) ? 1 : 0;
}

uint8_t* skwasm_memory(void* inst, size_t* size) {
    auto* m = static_cast<Module*>(inst);
    if (size) *size = m->memory.size();
    return m->memory.data();
}

int skwasm_memory_grow(void* inst, size_t min_bytes, char* err, size_t errlen) {
    auto* m = static_cast<Module*>(inst);
    if (min_bytes > MEM_CAP) {
        if (err && errlen) snprintf(err, errlen, "over 64MiB cap");
        return -1;
    }
    size_t pages = (min_bytes + PAGE - 1) / PAGE;
    if (m->memory.size() < pages * PAGE) m->memory.resize(pages * PAGE, 0);
    return 0;
}

int skwasm_call(void* inst, const char* name, const int64_t* args, int nargs,
                int64_t* results, int nresults, uint64_t fuel, char* err, size_t errlen) {
    auto* m = static_cast<Module*>(inst);
    auto it = m->func_exports.find(name);
    if (it == m->func_exports.end()) {
        if (err && errlen) snprintf(err, errlen, "no export %s", name);
        return -1;
    }
    try {
        Interp I(m, fuel ? fuel : 100'000'000ull);
        for (int i = 0; i < nargs; i++) I.push(uint64_t(args[i]));
        I.call_function(it->second);
        for (int i = nresults - 1; i >= 0; i--) results[i] = int64_t(I.pop());
        return 0;
    } catch (const std::exception& e) {
        if (err && errlen) snprintf(err, errlen, "%s", e.what());
        return -2;
    }
}

}  // extern "C"
