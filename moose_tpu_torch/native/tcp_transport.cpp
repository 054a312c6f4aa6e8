// Native TCP value transport (reference: moose/src/networking/tcpstream.rs,
// which is Rust; this framework's native layer is C++).
//
// Length-prefixed frames over persistent TCP connections:
//
//   frame := u64_le total_len | u32_le key_len | key bytes | value bytes
//
// Each server handle owns an accept loop plus per-connection reader
// threads feeding a rendezvous-keyed store (mutex + condition variable);
// receives may be posted before the matching frame arrives, matching the
// reference's AsyncCell discipline.  Exposed as a C ABI for ctypes.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Store {
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::vector<uint8_t>> values;

  void put(std::string key, std::vector<uint8_t> value) {
    {
      std::lock_guard<std::mutex> lock(mu);
      values[std::move(key)] = std::move(value);
    }
    cv.notify_all();
  }

  // returns false on timeout
  bool take(const std::string& key, std::vector<uint8_t>* out,
            int timeout_ms) {
    std::unique_lock<std::mutex> lock(mu);
    bool ok = cv.wait_for(lock, std::chrono::milliseconds(timeout_ms),
                          [&] { return values.count(key) > 0; });
    if (!ok) return false;
    auto it = values.find(key);
    *out = std::move(it->second);
    values.erase(it);
    return true;
  }
};

bool read_exact(int fd, uint8_t* buf, size_t len) {
  size_t got = 0;
  while (got < len) {
    ssize_t n = ::read(fd, buf + got, len - got);
    if (n <= 0) return false;
    got += static_cast<size_t>(n);
  }
  return true;
}

bool write_all(int fd, const uint8_t* buf, size_t len) {
  size_t sent = 0;
  while (sent < len) {
    ssize_t n = ::write(fd, buf + sent, len - sent);
    if (n <= 0) return false;
    sent += static_cast<size_t>(n);
  }
  return true;
}

struct Server {
  int listen_fd = -1;
  Store store;
  std::thread accept_thread;
  std::vector<std::thread> readers;
  std::vector<int> reader_fds;
  std::mutex readers_mu;
  bool stopping = false;

  void reader_loop(int fd) {
    for (;;) {
      uint8_t hdr[12];
      if (!read_exact(fd, hdr, sizeof(hdr))) break;
      uint64_t total;
      uint32_t key_len;
      std::memcpy(&total, hdr, 8);
      std::memcpy(&key_len, hdr + 8, 4);
      if (key_len + 4 > total || total > (1ull << 33)) break;  // 8 GiB cap
      std::vector<uint8_t> key(key_len);
      if (!read_exact(fd, key.data(), key_len)) break;
      size_t value_len = static_cast<size_t>(total) - 4 - key_len;
      std::vector<uint8_t> value(value_len);
      if (!read_exact(fd, value.data(), value_len)) break;
      store.put(std::string(key.begin(), key.end()), std::move(value));
    }
    ::close(fd);
  }

  void accept_loop() {
    for (;;) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) break;  // listener closed -> shutdown
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> lock(readers_mu);
      reader_fds.push_back(fd);
      readers.emplace_back([this, fd] { reader_loop(fd); });
    }
  }
};

// Persistent outbound connections, keyed "host:port" (process-global,
// like the reference's lazily-created channels, networking/grpc.rs:62-78).
std::mutex g_conn_mu;
std::map<std::string, int> g_conns;

int connect_to(const std::string& host, int port) {
  struct addrinfo hints;
  std::memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  std::string port_s = std::to_string(port);
  if (::getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0)
    return -1;
  int fd = -1;
  for (auto* p = res; p != nullptr; p = p->ai_next) {
    fd = ::socket(p->ai_family, p->ai_socktype, p->ai_protocol);
    if (fd < 0) continue;
    if (::connect(fd, p->ai_addr, p->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  if (fd >= 0) {
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return fd;
}

}  // namespace

extern "C" {

void* mt_server_new(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<struct sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      ::listen(fd, 64) < 0) {
    ::close(fd);
    return nullptr;
  }
  auto* srv = new Server();
  srv->listen_fd = fd;
  srv->accept_thread = std::thread([srv] { srv->accept_loop(); });
  return srv;
}

void mt_server_free(void* handle) {
  auto* srv = static_cast<Server*>(handle);
  if (srv == nullptr) return;
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  // force every reader's blocking read() to fail, then JOIN them before
  // deleting: a detached reader could touch srv->store after the free
  {
    std::lock_guard<std::mutex> lock(srv->readers_mu);
    for (int fd : srv->reader_fds) ::shutdown(fd, SHUT_RDWR);
  }
  for (auto& t : srv->readers) {
    if (t.joinable()) t.join();
  }
  srv->readers.clear();
  delete srv;
}

int mt_send(const char* host, int port, const char* key,
            const uint8_t* data, uint64_t len) {
  std::string conn_key = std::string(host) + ":" + std::to_string(port);
  std::lock_guard<std::mutex> lock(g_conn_mu);
  auto it = g_conns.find(conn_key);
  int fd = (it != g_conns.end()) ? it->second : -1;
  if (fd < 0) {
    fd = connect_to(host, port);
    if (fd < 0) return -1;
    g_conns[conn_key] = fd;
  }
  uint32_t key_len = static_cast<uint32_t>(std::strlen(key));
  uint64_t total = 4ull + key_len + len;
  std::vector<uint8_t> frame(12 + key_len);
  std::memcpy(frame.data(), &total, 8);
  std::memcpy(frame.data() + 8, &key_len, 4);
  std::memcpy(frame.data() + 12, key, key_len);
  if (!write_all(fd, frame.data(), frame.size()) ||
      !write_all(fd, data, len)) {
    ::close(fd);
    g_conns.erase(conn_key);
    return -2;
  }
  return 0;
}

// returns 0 on success, -1 on timeout; caller must mt_free(*out)
int mt_receive(void* handle, const char* key, uint8_t** out,
               uint64_t* out_len, int timeout_ms) {
  auto* srv = static_cast<Server*>(handle);
  std::vector<uint8_t> value;
  if (!srv->store.take(key, &value, timeout_ms)) return -1;
  *out = static_cast<uint8_t*>(std::malloc(value.size()));
  std::memcpy(*out, value.data(), value.size());
  *out_len = value.size();
  return 0;
}

void mt_free(uint8_t* buf) { std::free(buf); }

}  // extern "C"
